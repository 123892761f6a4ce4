from pbs_tpu_torch.data.bytes import (
    BOS,
    EOS,
    VOCAB,
    corpus_from_file,
    corpus_from_text,
    decode_tokens,
    encode_text,
)
from pbs_tpu_torch.data.loader import (Prefetcher, ShardedBatchSource,
                                        make_batch_source)
from pbs_tpu_torch.data.tokens import TokenDataset, write_token_file

__all__ = [
    "BOS",
    "EOS",
    "VOCAB",
    "Prefetcher",
    "ShardedBatchSource",
    "TokenDataset",
    "corpus_from_file",
    "corpus_from_text",
    "decode_tokens",
    "encode_text",
    "make_batch_source",
    "write_token_file",
]
