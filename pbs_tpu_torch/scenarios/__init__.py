"""pbs_tpu_torch.scenarios — coverage-guided adversarial scenario frontier.

The port of ``pbs_tpu.scenarios``, with its exports.

Find the pathologies before millions of users do
(docs/SCENARIOS.md): seeded scenario genomes compose arrival primitives
(diurnal waves, flash crowds, retry storms, long-context bursts,
tenant misbehavior, multi-region skew) into catalog-compatible
workloads + fault plans (genome.py); a stress scorer runs each
candidate through the sim/gateway/federation harnesses and measures
the invariant pressure it produces (score.py); a MAP-Elites hunt
keeps the best pressure per behavior signature, with every admission
re-proved under the full chaos invariant gate (hunt.py); and found
pathologies are promoted into a checked-in regression corpus replayed
by `pbst-torch scenarios replay --check` (corpus.py).

torch-free by construction: the whole stack rides the sim/gateway tier.
"""

from pbs_tpu_torch.scenarios.corpus import (
    CORPUS_DIR,
    PROMOTE_AXES,
    corpus_digest,
    corpus_paths,
    load_entry,
    make_entry,
    promote_frontier,
    replay_corpus,
    replay_entry,
    save_entry,
    whatif_entry,
    whatif_window,
)
from pbs_tpu_torch.scenarios.genome import (
    GENES,
    GENOME_VERSION,
    Gene,
    Genome,
    GenomeArrivals,
    derive_seed,
)
from pbs_tpu_torch.scenarios.hunt import (
    HuntConfig,
    archive_digest,
    hunt,
)
from pbs_tpu_torch.scenarios.score import (
    AXES,
    StressConfig,
    evaluate,
    evaluate_many,
    run_gate,
)

__all__ = [
    "AXES",
    "CORPUS_DIR",
    "GENES",
    "GENOME_VERSION",
    "PROMOTE_AXES",
    "Gene",
    "Genome",
    "GenomeArrivals",
    "HuntConfig",
    "StressConfig",
    "archive_digest",
    "corpus_digest",
    "corpus_paths",
    "derive_seed",
    "evaluate",
    "evaluate_many",
    "hunt",
    "load_entry",
    "make_entry",
    "promote_frontier",
    "replay_corpus",
    "replay_entry",
    "run_gate",
    "save_entry",
    "whatif_entry",
    "whatif_window",
]
