"""Scenario-discipline pass: the promoted corpus stays replayable.

The scenario subsystem's whole value is that a discovered pathology is
a PERMANENT regression test (docs/SCENARIOS.md): a corpus entry
replays because it records its genome, seed, harness config, and
golden digests, and a genome reproduces because it only ever comes
from the seeded factories. Both properties rot silently without a
checker. Two rules:

- ``scenario-corpus-golden``: a corpus entry
  (``pbs_tpu_torch/scenarios/corpus/*.json``) that is unparseable or
  missing its replay provenance — ``genome``, ``seed``, ``config``,
  or either golden digest. Such an entry LOOKS like a regression gate
  but ``pbst scenarios replay --check`` cannot hold it to anything.
  The corpus directory is checked whenever the scenarios package is
  in the scanned set (so the tier-1 tree selfcheck always covers the
  shipped corpus).
- ``scenario-raw-genome``: a direct ``Genome(...)`` construction
  outside the genome module itself. Hand-built genomes bypass the
  gene-table validation and the sha256-derived provenance the corpus
  and archive rely on; use ``Genome.from_seed`` / ``from_dict`` /
  ``mutate`` / ``crossover`` (the factories the determinism contract
  covers).

The port of ``pbs_tpu.analysis.scenariopass``. Departure: a file's place
is found by the path part ``pbs_tpu_torch`` (exactly that part, so a
tree that holds both packages anchors each file under its own) and
module prefixes ``pbs_tpu_torch.``; messages and hints name the port's
modules.
"""

from __future__ import annotations

import ast
import json
import os

from pbs_tpu_torch.analysis.core import (
    CheckContext,
    Finding,
    Pass,
    SourceFile,
    qualified_name,
)

#: Keys a corpus entry must carry to be replayable, plus the golden
#: digests checked separately (non-empty strings).
_CORPUS_KEYS = ("name", "genome", "seed", "config", "golden")


def _anchored(rel_path: str) -> str:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return "/".join(parts)


def _is_test_path(rel_path: str) -> bool:
    norm = rel_path.replace("\\", "/")
    return "tests/" in norm or \
        norm.rsplit("/", 1)[-1].startswith("test_")


class _GenomeScan(ast.NodeVisitor):
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        qual = qualified_name(node.func)
        if qual is not None and \
                (qual == "Genome" or qual.endswith(".Genome")):
            self.findings.append(Finding(
                check="scenario-raw-genome",
                path=self.src.rel_path,
                line=node.lineno, col=node.col_offset,
                message="scenario genome constructed outside the "
                        "seeded factories",
                hint="build genomes with Genome.from_seed / "
                     "from_dict / mutate / crossover — a hand-built "
                     "Genome(...) skips gene-table validation and "
                     "breaks the archive/corpus reproducibility "
                     "contract (docs/SCENARIOS.md)",
            ))
        self.generic_visit(node)


class ScenarioDisciplinePass(Pass):
    id = "scenario-discipline"
    rules = ("scenario-corpus-golden", "scenario-raw-genome")
    description = ("the promoted scenario corpus stays replayable: "
                   "corpus entries missing golden digests or replay "
                   "provenance, and Genome(...) constructions outside "
                   "the seeded factories, are findings")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _is_test_path(src.rel_path):
            return []
        anchored = _anchored(src.rel_path)
        if anchored.startswith("scenarios/"):
            # Remember scanned scenario packages; their corpus dirs
            # are validated once, in finalize.
            dirs = ctx.state.setdefault("scenario_corpus_dirs", {})
            pkg_dir = os.path.dirname(os.path.abspath(src.path))
            rel_dir = os.path.dirname(src.rel_path)
            if os.path.basename(pkg_dir) == "corpus":
                pkg_dir = os.path.dirname(pkg_dir)
                rel_dir = os.path.dirname(rel_dir)
            dirs.setdefault(os.path.join(pkg_dir, "corpus"),
                            (rel_dir + "/corpus") if rel_dir
                            else "corpus")
        if anchored == "scenarios/genome.py":
            return []
        scan = _GenomeScan(src)
        scan.visit(src.tree)
        return scan.findings

    def finalize(self, ctx: CheckContext) -> list[Finding]:
        findings: list[Finding] = []
        dirs = ctx.state.get("scenario_corpus_dirs", {})
        for corpus_dir in sorted(dirs):
            rel_dir = dirs[corpus_dir]
            if not os.path.isdir(corpus_dir):
                continue
            for fname in sorted(os.listdir(corpus_dir)):
                if not fname.endswith(".json"):
                    continue
                rel = f"{rel_dir}/{fname}"
                try:
                    with open(os.path.join(corpus_dir, fname)) as f:
                        entry = json.load(f)
                except (OSError, json.JSONDecodeError) as e:
                    findings.append(Finding(
                        check="scenario-corpus-golden", path=rel,
                        line=1, col=0,
                        message=f"corpus entry unreadable: {e}",
                        hint="regenerate with `pbst scenarios "
                             "promote` (docs/SCENARIOS.md)"))
                    continue
                if not isinstance(entry, dict):
                    findings.append(Finding(
                        check="scenario-corpus-golden", path=rel,
                        line=1, col=0,
                        message="corpus entry is not a JSON object",
                        hint="regenerate with `pbst scenarios "
                             "promote` (docs/SCENARIOS.md)"))
                    continue
                missing = [k for k in _CORPUS_KEYS
                           if k not in entry]
                golden = entry.get("golden")
                if isinstance(golden, dict):
                    for k in ("trace_digest", "report_digest"):
                        if not golden.get(k):
                            missing.append(f"golden.{k}")
                elif "golden" in entry:
                    # Present but not an object: replay_corpus would
                    # refuse it, so it is not a regression gate either.
                    missing.append("golden (not an object)")
                if missing:
                    findings.append(Finding(
                        check="scenario-corpus-golden", path=rel,
                        line=1, col=0,
                        message="corpus entry missing replay "
                                f"provenance: {', '.join(missing)}",
                        hint="a promoted scenario must carry genome "
                             "+ seed + config + golden trace/report "
                             "digests so `pbst scenarios replay "
                             "--check` can hold it; re-promote with "
                             "`pbst scenarios promote`"))
        return findings
