"""Determinism discipline for the digest-covered subsystems.

"Same seed, same digest" is the repo's replay contract: sim traces,
chaos schedules, scenario corpora and autopilot decisions are pinned
by golden SHA-256 digests, and CI replays them byte-for-byte. A
wall-clock read or an unseeded RNG inside one of those subsystems
breaks the contract *silently* — the digest only catches it after the
nondeterminism ships and the golden churns. This pass moves the check
to source level. Four rules, all scoped to the covered subsystems
(sim/, gateway/, scenarios/, faults/, autopilot/, serve/):

- ``det-wallclock``: ``time.time()``/``perf_counter()``/
  ``datetime.now()`` and friends. Real-clock seams are fine at the
  edges (gateway admission stamps wall time) — but they must be
  *declared*: a module-level ``REAL_CLOCK_SEAM = "<why>"`` string
  exempts the module from this rule and documents the seam.
- ``det-unseeded-rng``: ``random.Random()`` / ``default_rng()`` with
  no seed argument, ``random.SystemRandom``, and draws from the
  module-global ``random.*`` / legacy ``np.random.*`` state — all of
  which key off OS entropy or interpreter-global state the replay
  can't pin.
- ``det-urandom``: direct entropy taps — ``os.urandom``,
  ``uuid.uuid4``/``uuid1``, ``secrets.*``.
- ``det-set-iteration``: iterating a set (or joining/listing one)
  where the order can reach output — set iteration order depends on
  insertion history and hash randomization unless PYTHONHASHSEED is
  pinned, which the replay harness does not require.

The pass deliberately does NOT chase values through variables (a set
stored then sorted later is fine and common); it flags only the
syntactic shapes where the unordered iteration is direct. Honest
about limits: what it can't see, it skips.

The port of ``pbs_tpu.analysis.memmodel.detpass``. Departure: a file's
place is found by the path part ``pbs_tpu_torch`` (exactly that part, so
a tree that holds both packages anchors each file under its own) and
module prefixes ``pbs_tpu_torch.``; messages and hints name the port's
modules.
"""

from __future__ import annotations

import ast

from pbs_tpu_torch.analysis.core import CheckContext, Finding, Pass, SourceFile

#: First path components (under pbs_tpu_torch/) whose behaviour is pinned by
#: golden digests. Everything else may read clocks freely.
COVERED = frozenset({
    "sim", "gateway", "scenarios", "faults", "autopilot", "serve",
})

#: Module-level ``REAL_CLOCK_SEAM = "<why>"`` declares a sanctioned
#: wall-clock seam and exempts the module from det-wallclock only.
SEAM_MARKER = "REAL_CLOCK_SEAM"

_TIME_FUNCS = frozenset({
    "time", "time_ns", "perf_counter", "perf_counter_ns",
    "monotonic", "monotonic_ns", "process_time", "process_time_ns",
    "clock_gettime", "clock_gettime_ns",
})
_DATETIME_FUNCS = frozenset({"now", "utcnow", "today"})
_GLOBAL_DRAWS = frozenset({
    "random", "randint", "randrange", "uniform", "gauss", "normalvariate",
    "choice", "choices", "sample", "shuffle", "betavariate",
    "expovariate", "lognormvariate", "vonmisesvariate", "paretovariate",
    "weibullvariate", "triangular", "getrandbits", "randbytes",
})
_NP_GLOBAL_DRAWS = frozenset({
    "random", "rand", "randn", "randint", "random_sample", "ranf",
    "sample", "uniform", "normal", "choice", "shuffle", "permutation",
    "standard_normal", "exponential", "poisson", "beta", "gamma",
    "binomial", "bytes", "seed",
})


def _anchored(rel_path: str) -> str:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return "/".join(parts)


def _is_test(rel_path: str) -> bool:
    norm = rel_path.replace("\\", "/")
    return "tests/" in norm or norm.rsplit("/", 1)[-1].startswith("test_")


def _qualname(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain, '' if not a plain chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_setlike(node: ast.AST) -> bool:
    """Syntactically-definitely-a-set expression: a set display, a set
    comprehension, or a direct set()/frozenset() call."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    return False


class DeterminismDisciplinePass(Pass):
    id = "determinism-discipline"
    rules = ("det-wallclock", "det-unseeded-rng", "det-urandom",
             "det-set-iteration")
    description = (
        "the digest-covered subsystems (sim/gateway/scenarios/faults/"
        "autopilot/serve) stay replayable: no wall-clock reads outside "
        "declared REAL_CLOCK_SEAM modules, no unseeded or global-state "
        "RNG, no direct entropy taps, no set-iteration-order "
        "dependence — 'same seed, same digest' checked at source "
        "level, not after the golden churns")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _is_test(src.rel_path):
            return []
        anchored = _anchored(src.rel_path)
        first = anchored.split("/", 1)[0]
        if first not in COVERED:
            return []
        out: list[Finding] = []

        # from-imports of clock functions: `from time import monotonic`.
        time_aliases: dict[str, str] = {}
        seam = False
        for node in ast.iter_child_nodes(src.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in _TIME_FUNCS:
                        time_aliases[alias.asname or alias.name] = \
                            alias.name
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == SEAM_MARKER \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str) \
                    and node.value.value.strip():
                seam = True

        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                out.extend(self._check_call(node, src, time_aliases,
                                            seam))
            if isinstance(node, (ast.For, ast.AsyncFor)):
                out.extend(self._check_iter(node.iter, node.lineno,
                                            node.col_offset, src,
                                            "for loop iterates"))
            if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                 ast.GeneratorExp)):
                for gen in node.generators:
                    out.extend(self._check_iter(
                        gen.iter, gen.iter.lineno, gen.iter.col_offset,
                        src, "comprehension iterates"))
        return out

    # -- calls -----------------------------------------------------------

    def _check_call(self, node: ast.Call, src: SourceFile,
                    time_aliases: dict[str, str],
                    seam: bool) -> list[Finding]:
        out: list[Finding] = []
        q = _qualname(node.func)
        if not q:
            return out
        head, _, tail = q.rpartition(".")

        # det-wallclock ---------------------------------------------------
        if not seam:
            clock = None
            if head == "time" and tail in _TIME_FUNCS:
                clock = q
            elif not head and tail in time_aliases:
                clock = f"time.{time_aliases[tail]}"
            elif tail in _DATETIME_FUNCS and head.rpartition(".")[2] in \
                    ("datetime", "date"):
                clock = q
            if clock is not None:
                out.append(Finding(
                    "det-wallclock", src.rel_path, node.lineno,
                    node.col_offset,
                    f"{clock}() inside a digest-covered subsystem — "
                    "wall time differs every replay, so the digest "
                    "contract breaks silently",
                    hint="thread the virtual clock / recorded "
                         "timestamp through instead; if this module "
                         "really is a real-clock seam, declare "
                         'REAL_CLOCK_SEAM = "<why>" at module level'))

        # det-unseeded-rng ------------------------------------------------
        unseeded_ctor = (
            q == "random.Random" or
            (tail == "default_rng" and
             head.rpartition(".")[2] in ("random", "")))
        if unseeded_ctor and not node.args and not node.keywords:
            out.append(Finding(
                "det-unseeded-rng", src.rel_path, node.lineno,
                node.col_offset,
                f"{q}() constructed without a seed — keys off OS "
                "entropy, so two replays of the same scenario "
                "diverge",
                hint="pass the run's seed (every covered "
                     "subsystem threads one)"))
        if tail == "SystemRandom":
            out.append(Finding(
                "det-unseeded-rng", src.rel_path, node.lineno,
                node.col_offset,
                f"{q} draws from OS entropy by construction — "
                "unreplayable",
                hint="use random.Random(seed)"))
        if head == "random" and tail in _GLOBAL_DRAWS:
            out.append(Finding(
                "det-unseeded-rng", src.rel_path, node.lineno,
                node.col_offset,
                f"{q}() draws from the interpreter-global RNG — any "
                "other import can perturb the stream between replays",
                hint="draw from a locally-seeded random.Random"))
        if head in ("np.random", "numpy.random") and \
                tail in _NP_GLOBAL_DRAWS:
            out.append(Finding(
                "det-unseeded-rng", src.rel_path, node.lineno,
                node.col_offset,
                f"{q}() uses numpy's legacy global state — seeding it "
                "is process-wide action at a distance",
                hint="use np.random.default_rng(seed) held by the "
                     "caller"))

        # det-urandom -----------------------------------------------------
        if q in ("os.urandom",) or \
                (head == "uuid" and tail in ("uuid1", "uuid4")) or \
                head == "secrets" or head.startswith("secrets."):
            out.append(Finding(
                "det-urandom", src.rel_path, node.lineno,
                node.col_offset,
                f"{q}() taps OS entropy directly inside a "
                "digest-covered subsystem — ids/bytes differ every "
                "replay",
                hint="derive ids from the run seed (e.g. a counter or "
                     "a seeded Random's getrandbits)"))
        return out

    # -- set iteration ---------------------------------------------------

    def _check_iter(self, it: ast.AST, line: int, col: int,
                    src: SourceFile, what: str) -> list[Finding]:
        # Direct wrappers whose output order follows iteration order.
        target = it
        via = ""
        if isinstance(it, ast.Call):
            q = _qualname(it.func)
            if isinstance(it.func, ast.Name) and \
                    it.func.id in ("list", "tuple", "enumerate", "iter") \
                    and it.args:
                target = it.args[0]
                via = f" via {it.func.id}()"
            elif isinstance(it.func, ast.Attribute) and \
                    it.func.attr == "join" and it.args:
                target = it.args[0]
                via = " via str.join()"
            elif q in ("sorted",):
                return []  # sorted() launders the order — fine
        if not _is_setlike(target):
            return []
        return [Finding(
            "det-set-iteration", src.rel_path, line, col,
            f"{what} a set{via} — iteration order depends on hash "
            "randomization and insertion history, so anything derived "
            "from the order breaks the digest contract",
            hint="sort it first (sorted(...)) or use a list/dict, "
                 "which preserve insertion order")]
