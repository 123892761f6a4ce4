"""Promoted regression corpus: found pathologies become permanent CI.

The port of ``pbs_tpu.scenarios.corpus``, over its own copy of the
reference's corpus files (``CORPUS_DIR``), replayed at the goldens
they hold.

The point of the hunt is not the archive — it is that every discovered
pathology GRADUATES into a checked-in regression scenario
(``pbs_tpu_torch/scenarios/corpus/*.json``), exactly the way ``pbst-torch chaos``
plans and tuned-profile check blocks work today: genome + seed +
harness config + stress report + golden trace/report digests, replayed
by ``pbst-torch scenarios replay --check`` in tier-1. A later change that
moves ANY of a promoted scenario's digests fails CI — either the
change regressed the pathology's handling (fix it) or it legitimately
moved the behavior (re-promote in the same PR, like refreshing
``perf/baseline.json``).

Corpus entries are selected per STRESS AXIS (``promote_frontier``):
one scenario each for the invariant pressures worth pinning — SLO
burn, fairness collapse, lease-audit slack, … — so the corpus spans
qualitatively different failure shapes instead of five flavors of the
same flood. Every entry re-runs the full chaos invariant gate at
promotion time; nothing unreproducible or invariant-violating can be
promoted.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

from pbs_tpu_torch.scenarios.genome import Genome
from pbs_tpu_torch.scenarios.score import AXES, StressConfig, run_gate

CORPUS_VERSION = 1

#: The checked-in corpus (shipped regression scenarios).
CORPUS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "corpus")

#: Default promotion axes: the three invariant pressures the
#: acceptance bar pins (one scenario each, distinct entries).
PROMOTE_AXES = ("burn", "fairness", "slack")


def entry_name(axis: str, genome_digest: str) -> str:
    return f"{axis}-{genome_digest[:12]}"


def make_entry(axis: str, archive_entry: dict,
               stress_cfg: StressConfig, note: str = "") -> dict:
    """One corpus document from a hunt-archive entry (hunt.py
    ``_entry_from`` shape). The golden digests and the full harness
    config ride along so replay needs nothing but this file."""
    for key in ("genome", "seed", "axes", "score", "signature",
                "golden"):
        if key not in archive_entry:
            raise ValueError(f"archive entry missing {key!r}")
    golden = archive_entry["golden"]
    if not golden.get("trace_digest") or not golden.get("report_digest"):
        raise ValueError("archive entry carries no golden digests")
    # The note is data, kept word for word the reference's, so that
    # both packages promote the same archive entry to the same bytes.
    return {
        "version": CORPUS_VERSION,
        "name": entry_name(
            axis, Genome.from_dict(archive_entry["genome"]).digest()),
        "axis": axis,
        "note": note or (
            f"promoted by `pbst scenarios promote` (docs/SCENARIOS.md);"
            f" stresses the {axis} axis at "
            f"{archive_entry['axes'][axis]}. Regenerate in the same PR"
            " as any change that moves this scenario's digests —"
            " `pbst scenarios replay --check` gates it"),
        "config": stress_cfg.as_dict(),
        "genome": archive_entry["genome"],
        "seed": archive_entry["seed"],
        "stress": {
            "axes": archive_entry["axes"],
            "score": archive_entry["score"],
            "signature": archive_entry["signature"],
            "sim": archive_entry.get("sim", {}),
            "federation": archive_entry.get("federation", {}),
        },
        "golden": {
            "trace_digest": golden["trace_digest"],
            "report_digest": golden["report_digest"],
        },
    }


def save_entry(entry: dict, corpus_dir: str | None = None) -> str:
    """Atomic, stable-key write (corpus files are checked in)."""
    d = corpus_dir or CORPUS_DIR
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{entry['name']}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(entry, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_entry(path: str) -> dict:
    with open(path) as f:
        entry = json.load(f)
    if not isinstance(entry, dict):
        raise ValueError(f"{path}: corpus entry is not a JSON object")
    if entry.get("version") != CORPUS_VERSION:
        raise ValueError(
            f"{path}: corpus version {entry.get('version')!r} != "
            f"{CORPUS_VERSION}")
    for key in ("name", "genome", "seed", "config", "golden"):
        if key not in entry:
            raise ValueError(f"{path}: corpus entry missing {key!r}")
    for key in ("genome", "config", "golden"):
        if not isinstance(entry[key], dict):
            raise ValueError(
                f"{path}: corpus {key!r} must be an object")
    g = entry["golden"]
    if not g.get("trace_digest") or not g.get("report_digest"):
        raise ValueError(f"{path}: corpus entry missing golden digests")
    Genome.from_dict(entry["genome"])  # gene-table validation
    return entry


def corpus_paths(corpus_dir: str | None = None) -> list[str]:
    d = corpus_dir or CORPUS_DIR
    if not os.path.isdir(d):
        return []
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(".json")]


def corpus_digest(entries: list[dict]) -> str:
    """sha256 over the canonical corpus stream (sorted by name) — the
    whole-corpus determinism witness `pbst-torch scenarios replay` prints."""
    h = hashlib.sha256()
    for e in sorted(entries, key=lambda e: e["name"]):
        h.update(json.dumps(e, sort_keys=True,
                            separators=(",", ":")).encode())
        h.update(b"\n")
    return h.hexdigest()


def replay_entry(entry: dict, check: bool = True) -> dict:
    """Re-run one promoted scenario through the chaos invariant gate;
    ``check`` additionally demands byte-identical digests against the
    recorded goldens (the CI mode). Returns the verdict dict."""
    genome = Genome.from_dict(entry["genome"])
    cfg = StressConfig.from_dict(entry["config"])
    verdict = run_gate(genome, cfg,
                       expect=entry["golden"] if check else None)
    return {
        "name": entry["name"],
        "axis": entry.get("axis"),
        "ok": verdict["ok"],
        "problems": verdict["problems"],
        "expected_trace_digest": entry["golden"]["trace_digest"],
        "got_trace_digest": verdict["trace_digest"],
        "expected_report_digest": entry["golden"]["report_digest"],
        "got_report_digest": verdict["report_digest"],
        "admitted": verdict["admitted"],
        "completed": verdict["completed"],
    }


def replay_corpus(corpus_dir: str | None = None,
                  check: bool = True) -> dict:
    """Replay every corpus entry; the `pbst-torch scenarios replay` engine.
    ``ok`` = every entry held its invariants (and, with ``check``,
    its digests)."""
    entries = [load_entry(p) for p in corpus_paths(corpus_dir)]
    verdicts = [replay_entry(e, check=check) for e in entries]
    return {
        "version": CORPUS_VERSION,
        "corpus_dir": corpus_dir or CORPUS_DIR,
        "entries": len(entries),
        "corpus_digest": corpus_digest(entries),
        "verdicts": verdicts,
        "ok": bool(entries) and all(v["ok"] for v in verdicts),
    }


def whatif_window(entry: dict):
    """A promoted scenario as an autopilot shadow-replay input: the
    genome's arrival stream synthesized into a
    :class:`~pbs_tpu_torch.autopilot.recorder.ShadowWindow` (the workload
    IS arrivals — the recorder's own rule), with the same tenant
    admission contracts and the same per-tenant seeded streams the
    federation harness consumes (``catalog_arrivals`` tag 11). Open
    loop by construction: no gateway in sight, so shed-reactive
    shapes (retry storms) contribute their base pressure only — this
    is "the traffic the tenants ASK for", which is exactly what a
    shadow window captures at the submit seam."""
    from pbs_tpu_torch.autopilot.recorder import ShadowWindow
    from pbs_tpu_torch.gateway.chaos import catalog_arrivals, quota_for

    genome = Genome.from_dict(entry["genome"])
    cfg = StressConfig.from_dict(entry["config"])
    seed = int(entry["seed"])
    n_tenants = int(genome["n_tenants"])
    horizon_ns = cfg.ticks * cfg.tick_ns
    tenants = genome.build_tenants(seed, n_tenants, horizon_ns)
    model = genome.arrival_model(tenants, cfg.ticks, seed,
                                 n_gateways=cfg.n_gateways)
    rngs = catalog_arrivals(tenants, seed, tag=11)
    arrivals: list[tuple[int, str, str, int]] = []
    for tick in range(cfg.ticks):
        for t in tenants:
            fire, cost = model.draw(t, tick, rngs[t.name])
            if fire:
                arrivals.append(
                    (tick * cfg.tick_ns, t.name, t.slo, int(cost)))
    contracts = {}
    for t in tenants:
        q = quota_for(t.name, t.slo, t.params.weight)
        contracts[t.name] = {
            "rate": q.rate, "burst": q.burst, "weight": q.weight,
            "slo": q.slo, "max_queued": q.max_queued,
        }
    return ShadowWindow(t0_ns=0, t1_ns=horizon_ns,
                        arrivals=tuple(arrivals), tenants=contracts)


def whatif_entry(entry: dict, quick: bool = True,
                 workers: int = 1) -> dict:
    """Close the loop with the autopilot: what tuned profile would
    the shadow search propose if production traffic looked like this
    promoted pathology? Pure function of the entry (the search seeds
    from the synthesized window's digest), so the verdict is a stable
    artifact worth reading next to the scenario."""
    from pbs_tpu_torch.autopilot.shadow import classify_window, shadow_search

    window = whatif_window(entry)
    proposal = shadow_search(window, quick=quick, workers=workers)
    return {
        "name": entry["name"],
        "axis": entry.get("axis"),
        "window_digest": window.digest(),
        "arrivals": len(window.arrivals),
        "workload_class": classify_window(window),
        "proposal": proposal,
    }


def promote_frontier(hunt_result: dict,
                     corpus_dir: str | None = None,
                     axes=PROMOTE_AXES,
                     min_axis: float = 0.0) -> list[dict[str, Any]]:
    """Select + gate + write: for each requested axis, the archive
    entry with the highest value ON THAT AXIS (ties break on score
    then signature; an entry already promoted for an earlier axis is
    skipped, so the corpus files are distinct scenarios). Entries
    whose axis value is ≤ ``min_axis`` are skipped — promoting a
    scenario that does not actually stress its axis would pin noise.
    Each selected entry re-runs the invariant gate against its
    recorded goldens before anything is written."""
    archive = hunt_result.get("archive", {})
    stress_cfg = StressConfig.from_dict(
        hunt_result["config"]["stress"])
    taken: set[str] = set()
    out: list[dict[str, Any]] = []
    for axis in axes:
        if axis not in AXES:
            raise KeyError(f"unknown stress axis {axis!r}; "
                           f"known: {list(AXES)}")
        ranked = sorted(
            (e for sig, e in archive.items() if sig not in taken),
            key=lambda e: (-e["axes"][axis], -e["score"],
                           e["signature"]))
        if not ranked or ranked[0]["axes"][axis] <= min_axis:
            out.append({"axis": axis, "promoted": False,
                        "reason": "no archive entry stresses this "
                                  "axis above the floor"})
            continue
        entry = ranked[0]
        taken.add(entry["signature"])
        genome = Genome.from_dict(entry["genome"])
        verdict = run_gate(genome, stress_cfg,
                           expect=entry["golden"])
        if not verdict["ok"]:
            out.append({"axis": axis, "promoted": False,
                        "reason": "invariant gate rejected the "
                                  "candidate at promotion",
                        "problems": verdict["problems"][:5]})
            continue
        doc = make_entry(axis, entry, stress_cfg)
        path = save_entry(doc, corpus_dir)
        out.append({"axis": axis, "promoted": True, "path": path,
                    "name": doc["name"],
                    "axis_value": entry["axes"][axis],
                    "score": entry["score"]})
    return out
