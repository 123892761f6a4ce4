"""Byte-level tokenization: text in, training out, zero dependencies.

The input pipeline (``tokens.py``/``loader.py``) consumes token files;
this module closes the loop from raw text without an external
tokenizer (none can be downloaded in an egress-free environment, and
the reference has no NLP stack to borrow from): UTF-8 bytes are the
tokens (ByT5/CANINE-style), with two specials. Vocab 258 —
``0..255`` bytes, ``BOS=256``, ``EOS=257`` — so any
``TransformerConfig(vocab=258)`` model trains on any text file, and
any generated token stream decodes back to text losslessly.

The port of ``pbs_tpu.data.bytes``, line for line.
"""

from __future__ import annotations

import numpy as np

BOS = 256
EOS = 257
VOCAB = 258


def encode_text(text: str, add_bos: bool = True,
                add_eos: bool = True) -> np.ndarray:
    """UTF-8 bytes + specials, int32."""
    body = np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(
        np.int32)
    parts = []
    if add_bos:
        parts.append(np.array([BOS], np.int32))
    parts.append(body)
    if add_eos:
        parts.append(np.array([EOS], np.int32))
    return np.concatenate(parts)


def decode_tokens(tokens) -> str:
    """Inverse of :func:`encode_text`: drops specials, decodes UTF-8
    (replacement char for any invalid byte run a sampled stream might
    produce)."""
    arr = np.asarray(tokens).reshape(-1)
    body = arr[(arr >= 0) & (arr < 256)].astype(np.uint8)
    return body.tobytes().decode("utf-8", errors="replace")


def corpus_from_text(out_path: str, texts, doc_separator: bool = True
                     ) -> int:
    """Write a packed token file (``tokens.write_token_file`` format)
    from an iterable of document strings (or one big string). Each
    document is BOS…EOS-delimited when ``doc_separator``; returns the
    total token count."""
    from pbs_tpu_torch.data.tokens import write_token_file

    if isinstance(texts, str):
        texts = [texts]
    chunks = [encode_text(t, add_bos=doc_separator,
                          add_eos=doc_separator) for t in texts]
    tokens = (np.concatenate(chunks) if chunks
              else np.zeros((0,), np.int32))
    write_token_file(out_path, tokens)
    return int(tokens.size)


def corpus_from_file(out_path: str, text_path: str) -> int:
    """Text file -> packed token corpus (one document)."""
    with open(text_path, encoding="utf-8") as f:
        return corpus_from_text(out_path, f.read())
