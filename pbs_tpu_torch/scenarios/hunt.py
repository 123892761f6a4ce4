"""Coverage-guided scenario hunt: an elite archive over behavior space.

The port of ``pbs_tpu.scenarios.hunt``: a seeded hunt's archive digest
is the reference's on any worker count.

A MAP-Elites-shaped loop (`pbst-torch scenarios hunt`): seed a population of
random genomes, evaluate each through the stress scorer (score.py),
and keep the archive's best stress score PER BEHAVIOR SIGNATURE — the
discretized (burn, fairness, slack, gap, shed) cell. Coverage guidance
falls out of the key: a candidate only displaces an incumbent that
stresses the invariants the SAME way but harder; a candidate with a
new signature claims new territory however mediocre its score. The
next generation breeds from the archive (mutation + crossover of
elites), so search pressure concentrates where stress was found while
the signature grid keeps it spread across qualitatively different
pathologies.

Admission is gated: every would-be archive entry re-runs under the
full chaos invariant gate (score.run_gate — no-job-lost, mint bound,
span continuity, same-seed-same-digest). A candidate whose replay
drifts or whose run violates an invariant is REJECTED and logged; the
archive holds only reproducible, invariant-clean pathologies, which
is what makes promotion (corpus.py) sound.

Determinism: populations, breeding choices, and admission order are
pure functions of the hunt seed (sha256-derived streams, sorted
iteration); evaluations are shared-nothing and order-preserved
(score.evaluate_many), so the archive — and its digest — is
byte-identical on any worker count. The loop constants (population,
generations, rates, archive bounds) come from the ``scenarios.hunt.*``
registry knobs: hunts are tunable through the knob channel, no code
edits.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

import numpy as np

from pbs_tpu_torch.scenarios.genome import Genome, derive_seed
from pbs_tpu_torch.scenarios.score import (
    AXES,
    StressConfig,
    evaluate_many,
    run_gate,
)

HUNT_VERSION = 1


def _knob(name: str):
    from pbs_tpu_torch import knobs

    return knobs.get(name)


@dataclasses.dataclass(frozen=True)
class HuntConfig:
    """One hunt's shape. Defaults come from the ``scenarios.hunt.*``
    knobs at construction time (``HuntConfig.from_knobs``), so a
    push of ``scenarios.hunt.population=32`` changes the next
    hunt without touching code."""

    seed: int = 0
    population: int = 8
    generations: int = 4
    mutation_rate: float = 0.35
    crossover_rate: float = 0.5
    archive_max: int = 64
    stress: StressConfig = dataclasses.field(
        default_factory=StressConfig)

    @classmethod
    def from_knobs(cls, seed: int = 0,
                   stress: StressConfig | None = None) -> "HuntConfig":
        return cls(
            seed=int(seed),
            population=int(_knob("scenarios.hunt.population")),
            generations=int(_knob("scenarios.hunt.generations")),
            mutation_rate=float(_knob("scenarios.hunt.mutation_rate")),
            crossover_rate=float(
                _knob("scenarios.hunt.crossover_rate")),
            archive_max=int(_knob("scenarios.hunt.archive_max")),
            stress=stress or StressConfig(base_seed=int(seed)),
        )

    @classmethod
    def demo(cls, seed: int = 0) -> "HuntConfig":
        """The tier-1 smoke shape: a real (tiny) hunt in a few
        seconds on a loaded 1-vCPU host."""
        return cls(seed=int(seed), population=4, generations=2,
                   stress=StressConfig.demo(base_seed=int(seed)))

    def as_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["stress"] = self.stress.as_dict()
        return d


def archive_digest(archive: dict[str, dict]) -> str:
    """sha256 over the canonical archive — the hunt's determinism
    witness (same seed + config ⇒ same digest, any worker count)."""
    payload = json.dumps(archive, sort_keys=True,
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def _entry_from(result: dict) -> dict:
    """The archived slice of a stress report (everything promotion and
    replay need; canonical key order via sorted dumps later)."""
    return {
        "genome": result["genome"],
        "seed": result["seed"],
        "axes": result["axes"],
        "score": result["score"],
        "signature": result["signature"],
        "sim": result["sim"],
        "federation": result["federation"],
        "golden": result["golden"],
    }


def _breed(archive: dict[str, dict], cfg: HuntConfig,
           generation: int) -> list[Genome]:
    """Next population from the elites: a seeded, pure-function mix of
    elite mutation, elite crossover, and fresh blood when the archive
    is still thin."""
    elites = [archive[sig] for sig in
              sorted(archive, key=lambda s: (-archive[s]["score"], s))]
    out: list[Genome] = []
    for i in range(cfg.population):
        slot_seed = derive_seed("breed", cfg.seed, generation, i)
        if not elites:
            out.append(Genome.from_seed(slot_seed))
            continue
        rng = np.random.default_rng(slot_seed)
        u = float(rng.random())
        a = Genome.from_dict(
            elites[int(rng.integers(0, len(elites)))]["genome"])
        if u < cfg.crossover_rate and len(elites) > 1:
            b = Genome.from_dict(
                elites[int(rng.integers(0, len(elites)))]["genome"])
            child = a.crossover(b, slot_seed)
            # A self-cross is the identity: fall through to mutation
            # so the slot still explores.
            if child.digest() == a.digest():
                child = a.mutate(slot_seed, rate=cfg.mutation_rate)
        else:
            child = a.mutate(slot_seed, rate=cfg.mutation_rate)
        out.append(child)
    return out


def hunt(cfg: HuntConfig, workers: int = 1,
         progress=None) -> dict:
    """Run the loop; returns the hunt document:
    ``{"archive": {signature: entry}, "archive_digest", "log",
    "rejected", ...}``. ``progress`` (optional callable) receives one
    line per generation."""
    archive: dict[str, dict] = {}
    seen: set[str] = set()
    rejected: list[dict] = []
    log: list[dict] = []
    population = [
        Genome.from_seed(derive_seed("init", cfg.seed, i))
        for i in range(cfg.population)
    ]
    for generation in range(cfg.generations):
        fresh: list[Genome] = []
        for g in population:
            if g.digest() not in seen:
                seen.add(g.digest())
                fresh.append(g)
        results = evaluate_many(fresh, cfg.stress, workers=workers)
        admitted = 0
        for genome, res in zip(fresh, results):
            sig = res["signature"]
            incumbent = archive.get(sig)
            if incumbent is not None and \
                    res["score"] <= incumbent["score"]:
                continue
            # Frontier candidate: through the full invariant gate
            # before it may displace anything. A candidate whose OWN
            # evaluation already violated an invariant is rejected
            # without paying for the gate's federation replay.
            if not res["ok"]:
                rejected.append({
                    "generation": generation,
                    "signature": sig,
                    "genome_digest": genome.digest(),
                    "problems": res["problems"][:5],
                })
                continue
            verdict = run_gate(genome, cfg.stress, expect=res["golden"])
            if not verdict["ok"]:
                rejected.append({
                    "generation": generation,
                    "signature": sig,
                    "genome_digest": genome.digest(),
                    "problems": verdict["problems"][:5],
                })
                continue
            archive[sig] = _entry_from(res)
            admitted += 1
        # Bound the archive: evict the weakest cells, loudly.
        evicted = 0
        while len(archive) > cfg.archive_max:
            worst = min(archive,
                        key=lambda s: (archive[s]["score"], s))
            del archive[worst]
            evicted += 1
        best = max((e["score"] for e in archive.values()),
                   default=0.0)
        entry = {
            "generation": generation,
            "evaluated": len(fresh),
            "admitted": admitted,
            "evicted": evicted,
            "archive_size": len(archive),
            "best_score": best,
        }
        log.append(entry)
        if progress is not None:
            progress(
                f"gen {generation}: evaluated {len(fresh)} "
                f"admitted {admitted} archive {len(archive)} "
                f"best {best:.4f}")
        if generation + 1 < cfg.generations:
            population = _breed(archive, cfg, generation)
    return {
        "version": HUNT_VERSION,
        "config": cfg.as_dict(),
        "axes": list(AXES),
        "archive": {sig: archive[sig] for sig in sorted(archive)},
        "archive_digest": archive_digest(
            {sig: archive[sig] for sig in sorted(archive)}),
        "log": log,
        "rejected": rejected,
    }
