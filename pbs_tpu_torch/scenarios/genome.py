"""Typed, seeded scenario genomes: the traffic shapes nobody wrote down.

The port of ``pbs_tpu.scenarios.genome``: the same genes, streams and
digests, so a seed gives the reference's genome.

The workload catalog carries five hand-written mixes; the pathologies
the paper cares about (lock-holder-preemption-style interference,
contention collapse) emerge from traffic SHAPES — diurnal waves, flash
crowds, retry storms after a front-door death, correlated long-context
bursts, tenant misbehavior, multi-region skew. A :class:`Genome` is a
flat, typed, bounded gene vector that composes those primitives into

- a catalog-compatible workload (``build_tenants`` → the shared
  :func:`pbs_tpu_torch.sim.workload.make_mix` constructor, so genome tenants
  and hand-written mixes come from ONE generator set),
- a gateway/federation arrival shape (:class:`GenomeArrivals`, an
  :class:`~pbs_tpu_torch.gateway.chaos.ArrivalModel`), and
- a :class:`~pbs_tpu_torch.faults.plan.FaultPlan` (genome-driven front-door
  adversity, docs/FAULTS.md).

Every operator is a pure function of a sha256-derived seed:
``from_seed``, ``mutate``, and ``crossover`` produce byte-identical
genomes for the same inputs on any host, which is what makes the hunt
archive (hunt.py) and the promoted corpus (corpus.py) replayable CI
artifacts. Construct genomes ONLY through those factories (or
``from_dict`` on a validated gene dict) — the ``scenario-discipline``
check pass flags raw ``Genome(...)`` calls outside this module.

XOS's lens (PAPERS.md, arXiv 1901.00825) shaped the gene set: each
misbehavior primitive stresses a policy travelling with the TENANT
(its admission contract, its lease slice, its SLO class), not the box.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math

import numpy as np

from pbs_tpu_torch.faults.plan import FaultPlan, FaultSpec
from pbs_tpu_torch.gateway.admission import BATCH, INTERACTIVE
from pbs_tpu_torch.gateway.chaos import ArrivalModel
from pbs_tpu_torch.sim.workload import TenantSpec, make_mix
from pbs_tpu_torch.utils.clock import MS

GENOME_VERSION = 1

#: Decimal places every float gene is rounded to at creation: the
#: canonical JSON of a genome — and therefore its digest — is
#: byte-stable across hosts.
_ROUND = 6


@dataclasses.dataclass(frozen=True)
class Gene:
    """One typed, bounded gene."""

    name: str
    kind: str  # "int" | "float"
    lo: int | float
    hi: int | float
    doc: str = ""


#: The gene vector, in canonical order. Mutation/crossover walk this
#: table, so adding a gene extends every operator at once.
GENES: tuple[Gene, ...] = (
    # -- tenant composition (feeds make_mix) ---------------------------
    Gene("n_tenants", "int", 3, 8, "tenants in the mix"),
    Gene("w_hbm", "float", 0.0, 1.0, "kind weight: memory-bound steady"),
    Gene("w_coll", "float", 0.0, 1.0, "kind weight: collective-contended"),
    Gene("w_compute", "float", 0.0, 1.0, "kind weight: compute-bound"),
    Gene("w_alt", "float", 0.0, 1.0, "kind weight: phase-alternating"),
    Gene("w_serve", "float", 0.0, 1.0, "kind weight: bursty serving"),
    # -- arrival shape (feeds GenomeArrivals) --------------------------
    Gene("rate_interactive", "float", 0.05, 0.90,
         "base per-tick fire probability, interactive tenants"),
    Gene("rate_batch", "float", 0.02, 0.60,
         "base per-tick fire probability, batch tenants"),
    Gene("diurnal_amp", "float", 0.0, 1.0,
         "diurnal wave amplitude over the run"),
    Gene("diurnal_periods", "int", 1, 6, "diurnal cycles per run"),
    Gene("flash_at", "float", 0.0, 1.0,
         "flash-crowd start (fraction of the run)"),
    Gene("flash_len", "float", 0.0, 0.3, "flash-crowd length fraction"),
    Gene("flash_mult", "float", 1.0, 8.0,
         "fire-probability multiplier inside the flash window"),
    Gene("retry_mult", "int", 0, 4,
         "thundering-herd factor: forced re-submissions per shed"),
    Gene("longctx_at", "float", 0.0, 1.0,
         "correlated long-context burst start fraction"),
    Gene("longctx_len", "float", 0.0, 0.3, "long-context burst length"),
    Gene("longctx_mult", "float", 1.0, 6.0,
         "batch cost multiplier inside the burst (burst-capped)"),
    Gene("oversize_p", "float", 0.0, 0.3,
         "probability a batch request is oversized-but-legal (cost in "
         "(burst/N, burst]: the lease-borrow path)"),
    Gene("spray_frac", "float", 0.0, 0.5,
         "fraction of tenants misbehaving: firing at max rate every "
         "tick regardless of shape (gateway spraying)"),
    Gene("region_skew", "float", 0.0, 1.0,
         "multi-region skew: first-half tenants run hot, second-half "
         "cold, concentrating load on their ring homes"),
    # -- fault shape (feeds fault_plan) --------------------------------
    Gene("death_p", "float", 0.0, 0.01, "gateway.death kill probability"),
    Gene("partition_p", "float", 0.0, 0.01,
         "gateway.partition probability"),
    Gene("partition_ms", "int", 5, 40, "partition heal time"),
    Gene("lease_expire_p", "float", 0.0, 0.9,
         "lease.expire renewal-refusal probability (a lapse needs "
         "consecutive refusals across a TTL, so the degraded "
         "conservative-bucket regime only shows up near the top of "
         "this range)"),
    Gene("admit_shed_p", "float", 0.0, 0.03,
         "gateway.admit injected-shed probability"),
    Gene("misroute_p", "float", 0.0, 0.15,
         "gateway.route misroute probability"),
    # -- crash shape (feeds crash_plan; docs/DURABILITY.md). These are
    # EXTENSION genes: serialized only when nonzero, so every genome
    # and corpus entry minted before they existed keeps its digest —
    # and its recorded golden replay — byte-identical.
    Gene("crash_p", "float", 0.0, 0.008,
         "gateway.process.kill whole-process death probability per "
         "harness tick (journal-recovered kill-9)"),
    Gene("crash_positions", "int", 0, 3,
         "deterministic kill-9 count, bucketized: k kills land at "
         "evenly spaced tick fractions i/(k+1) of the run"),
)

#: Genes added after the corpus format shipped: zero is the exact
#: pre-gene behavior, omitted from the canonical serialization so old
#: digests cannot move, and defaulted to zero on load.
EXTENSION_GENES = ("crash_p", "crash_positions")

_GENES_BY_NAME = {g.name: g for g in GENES}

#: Tenant kinds a genome composes, in the weight-gene order above.
_KIND_ORDER = ("hbm", "coll", "compute", "alt", "serve")


def derive_seed(*parts) -> int:
    """sha256-fold arbitrary labelled parts into a 63-bit seed — the
    ONLY seed derivation the scenario subsystem uses (sweep's
    ``cell_seed`` idiom), so every stream is independent, labelled,
    and platform-stable."""
    h = hashlib.sha256("|".join(str(p) for p in parts).encode())
    return int.from_bytes(h.digest()[:8], "big") & ((1 << 63) - 1)


def _coerce(gene: Gene, value) -> int | float:
    if gene.kind == "int":
        v = int(value)
    else:
        v = round(float(value), _ROUND)
    return min(gene.hi, max(gene.lo, v))


@dataclasses.dataclass(frozen=True)
class Genome:
    """An immutable gene dict plus the derived identity digest.

    Do not call the constructor directly — genomes come from the
    seeded factories (``from_seed``/``mutate``/``crossover``) or from
    a serialized dict (``from_dict``), which is what keeps every
    genome in an archive or corpus reproducible from its recorded
    provenance (the ``scenario-raw-genome`` rule enforces this)."""

    genes: tuple[tuple[str, int | float], ...]

    # -- identity --------------------------------------------------------

    def __getitem__(self, name: str) -> int | float:
        for k, v in self.genes:
            if k == name:
                return v
        raise KeyError(name)

    def as_dict(self) -> dict:
        # Extension genes serialize only when nonzero (zero IS the
        # pre-gene behavior): a genome that never crashes has the same
        # canonical bytes — and digest, and eval seed, and recorded
        # golden replay — it had before the genes existed.
        return {"version": GENOME_VERSION,
                "genes": {k: v for k, v in self.genes
                          if v != 0 or k not in EXTENSION_GENES}}

    def canonical(self) -> str:
        return json.dumps(self.as_dict(), sort_keys=True,
                          separators=(",", ":"))

    def digest(self) -> str:
        return hashlib.sha256(self.canonical().encode()).hexdigest()

    def name(self) -> str:
        """The registered-workload name (embeds the content digest, so
        re-registering is idempotent by construction)."""
        return f"scn:{self.digest()[:16]}"

    # -- factories -------------------------------------------------------

    @classmethod
    def _from_values(cls, values: dict) -> "Genome":
        genes = tuple((g.name, _coerce(g, values[g.name])) for g in GENES)
        return cls(genes=genes)

    @classmethod
    def from_seed(cls, seed: int) -> "Genome":
        """Uniform draw of every gene from its declared range."""
        rng = np.random.default_rng(derive_seed("genome", seed))
        values = {}
        for g in GENES:
            if g.kind == "int":
                values[g.name] = int(rng.integers(g.lo, int(g.hi) + 1))
            else:
                values[g.name] = float(rng.uniform(g.lo, g.hi))
        return cls._from_values(values)

    @classmethod
    def from_dict(cls, d: dict) -> "Genome":
        """Validated load (corpus/archive entries). Unknown, missing,
        or out-of-range genes are errors — a corpus entry that no
        longer fits the declared gene table must fail loudly, not
        silently clamp into a different scenario."""
        if d.get("version") != GENOME_VERSION:
            raise ValueError(
                f"genome version {d.get('version')!r} != "
                f"{GENOME_VERSION}")
        raw = d.get("genes")
        if not isinstance(raw, dict):
            raise ValueError("genome carries no genes dict")
        # Absent extension genes mean zero (their omitted-when-zero
        # serialization), never an error: pre-extension corpus
        # entries stay loadable at their recorded digests.
        raw = {**{g: 0 for g in EXTENSION_GENES}, **raw}
        unknown = sorted(set(raw) - set(_GENES_BY_NAME))
        missing = sorted(set(_GENES_BY_NAME) - set(raw))
        if unknown or missing:
            raise ValueError(
                f"genome genes mismatch: unknown={unknown} "
                f"missing={missing}")
        for name, value in raw.items():
            g = _GENES_BY_NAME[name]
            if isinstance(value, bool) or \
                    not isinstance(value, (int, float)):
                raise ValueError(f"gene {name}: {value!r} not a number")
            if not (g.lo <= value <= g.hi):
                raise ValueError(
                    f"gene {name}: {value!r} outside [{g.lo}, {g.hi}]")
        return cls._from_values(raw)

    def mutate(self, seed: int, rate: float = 0.35) -> "Genome":
        """Perturb each gene with probability ``rate`` (gaussian step
        scaled to the gene's range, clamped); at least one gene always
        moves. Pure function of (self, seed, rate)."""
        rng = np.random.default_rng(
            derive_seed("mutate", self.digest(), seed,
                        round(float(rate), _ROUND)))
        # Fixed consumption: one pick-draw and one step-draw per gene,
        # plus one forced-gene index — branch-free stream usage.
        picks = rng.random(len(GENES))
        steps = rng.standard_normal(len(GENES))
        forced = int(rng.integers(0, len(GENES)))
        values = {}
        moved = False
        for i, g in enumerate(GENES):
            v = self[g.name]
            if picks[i] < rate or i == forced:
                span = float(g.hi) - float(g.lo)
                v = _coerce(g, float(v) + 0.25 * span * float(steps[i]))
                if g.kind == "int" and v == self[g.name]:
                    # An int gene whose step rounded away still moves
                    # (deterministically, toward the far bound).
                    v = _coerce(g, v + (1 if steps[i] >= 0 else -1))
                moved = moved or v != self[g.name]
            values[g.name] = v
        if not moved:
            # Every picked gene was already pinned at a bound it
            # stepped into: flip the forced gene across its range.
            g = GENES[forced]
            cur = self[g.name]
            flipped = _coerce(
                g, float(g.hi) + float(g.lo) - float(cur))
            if flipped == cur:
                # The flip is the identity at the exact range
                # midpoint — send the gene to a bound instead, so
                # "at least one gene always moves" actually holds.
                flipped = _coerce(
                    g, g.lo if float(cur) >
                    (float(g.lo) + float(g.hi)) / 2 else g.hi)
            values[g.name] = flipped
        return type(self)._from_values(values)

    def crossover(self, other: "Genome", seed: int) -> "Genome":
        """Uniform per-gene crossover: each gene comes from self or
        ``other``. Pure function of (self, other, seed)."""
        rng = np.random.default_rng(
            derive_seed("cross", self.digest(), other.digest(), seed))
        take = rng.random(len(GENES))
        values = {
            g.name: (self[g.name] if take[i] < 0.5 else other[g.name])
            for i, g in enumerate(GENES)
        }
        return type(self)._from_values(values)

    # -- bridges ---------------------------------------------------------

    def tenant_kinds(self, seed: int, n_tenants: int) -> list[str]:
        """Per-tenant kind choices from the weight genes: a seeded
        categorical draw (pure function of genome + seed). At least
        one always-on tenant is guaranteed — a mix of only bursty
        serving tenants would idle the partition between bursts."""
        w = np.array([max(1e-6, float(self[f"w_{k}"]))
                      for k in _KIND_ORDER])
        w = w / w.sum()
        rng = np.random.default_rng(
            derive_seed("kinds", self.digest(), seed))
        kinds = [
            _KIND_ORDER[int(rng.choice(len(_KIND_ORDER), p=w))]
            for _ in range(max(1, int(n_tenants)))
        ]
        if all(k == "serve" for k in kinds):
            kinds[0] = "hbm"
        return kinds

    def build_tenants(self, seed: int, n_tenants: int,
                      horizon_ns: int) -> list[TenantSpec]:
        """The genome→workload bridge: catalog-compatible tenants via
        the SAME :func:`make_mix` constructor the hand-written catalog
        uses."""
        return make_mix(self.tenant_kinds(seed, n_tenants), seed,
                        horizon_ns)

    def register(self):
        """Register this genome's workload builder under
        :meth:`name` so the sim engine and chaos harnesses run it by
        name. Returns the name; pair with
        ``sim.workload.unregister_workload`` when done."""
        from pbs_tpu_torch.sim.workload import register_workload

        return register_workload(
            self.name(),
            lambda seed, n, horizon_ns: self.build_tenants(
                seed, n, horizon_ns))

    def fault_plan(self, seed: int) -> FaultPlan:
        """Genome-driven front-door adversity: the federation fault
        points at the genome's probabilities (docs/FAULTS.md). Zero-
        probability specs are omitted so the plan dict — which the
        chaos report records — names only the pressure actually
        applied."""
        g = self
        specs: list[FaultSpec] = []
        if g["death_p"] > 0:
            specs.append(FaultSpec("gateway.death", "kill",
                                   p=g["death_p"], after=20, times=2))
        if g["partition_p"] > 0:
            specs.append(FaultSpec(
                "gateway.partition", "partition", p=g["partition_p"],
                times=3,
                args={"duration_ns": int(g["partition_ms"]) * MS}))
        if g["lease_expire_p"] > 0:
            specs.append(FaultSpec("lease.expire", "expire",
                                   p=g["lease_expire_p"]))
        if g["admit_shed_p"] > 0:
            specs.append(FaultSpec(
                "gateway.admit", "shed", p=g["admit_shed_p"],
                args={"retry_after_ns": 10 * MS}))
        if g["misroute_p"] > 0:
            specs.append(FaultSpec("gateway.route", "misroute",
                                   p=g["misroute_p"]))
        return FaultPlan(seed=int(seed), specs=tuple(specs)).validate()

    def gateway_fault_plan(self, seed: int) -> FaultPlan:
        """The single-gateway subset (no federation seams) for the
        ``run_gateway_chaos`` leg of the stress scorer."""
        g = self
        specs = []
        if g["admit_shed_p"] > 0:
            specs.append(FaultSpec(
                "gateway.admit", "shed", p=g["admit_shed_p"],
                args={"retry_after_ns": 10 * MS}))
        if g["misroute_p"] > 0:
            specs.append(FaultSpec("gateway.route", "misroute",
                                   p=g["misroute_p"]))
        return FaultPlan(seed=int(seed), specs=tuple(specs)).validate()

    def crash_plan(self, ticks: int) -> "list[dict] | None":
        """The crash genes as a ``run_federation_chaos(crash_plan=)``
        schedule (docs/DURABILITY.md): ``crash_positions`` kills land
        at evenly spaced tick fractions, ``crash_p`` adds seeded
        probabilistic kills (times-capped). Both zero — the
        pre-extension genome — returns None, which arms no journal
        and keeps every recorded golden byte-identical."""
        p = float(self["crash_p"])
        k = int(self["crash_positions"])
        if p == 0 and k == 0:
            return None
        plan: list[dict] = []
        for j in range(k):
            plan.append({"tick": ((j + 1) * int(ticks)) // (k + 1)})
        if p > 0:
            plan.append({"p": p, "times": 2, "after": 20})
        return plan

    def process_kill_plan(self, ticks: int, seed: int) -> "list[dict] | None":
        """The crash genes realized for PROCESS MODE (docs/GATEWAY.md
        "Process mode"), where every kill is a literal SIGKILL to a
        member pid and must be tick-positioned — a real signal cannot
        be aimed at a byte offset, and the probabilistic ``crash_p``
        stream has no in-process consult point to ride. So the
        probabilistic gene is realized HERE, seeded and times-capped
        (2) like the in-process plan entry it mirrors, into concrete
        ticks; ``crash_positions`` lands at the same evenly spaced
        fractions as ``crash_plan``. Both genes zero returns None: a
        genome that never crashes kills no processes."""
        p = float(self["crash_p"])
        k = int(self["crash_positions"])
        if p == 0 and k == 0:
            return None
        plan = [{"tick": ((j + 1) * int(ticks)) // (k + 1)}
                for j in range(k)]
        if p > 0:
            rng = np.random.default_rng(int(seed) * 9176 + 77)
            fired = 0
            for t in range(20, int(ticks)):
                if fired >= 2:
                    break
                if rng.random() < p:
                    plan.append({"tick": t})
                    fired += 1
        plan.sort(key=lambda e: e["tick"])
        return plan or None

    def arrival_model(self, tenants, ticks: int, seed: int,
                      n_gateways: int = 3) -> "GenomeArrivals":
        return GenomeArrivals(self, tenants, ticks, seed,
                              n_gateways=n_gateways)


class GenomeArrivals(ArrivalModel):
    """The genome's per-tick traffic shape over the chaos harness's
    per-tenant rng streams.

    Determinism contract: ``draw`` consumes a FIXED number of stream
    draws per call (fire, interactive cost, batch cost, oversize)
    whatever branch the shape takes, so the decision stream is a pure
    function of the harness seed — the same rule the stock
    :func:`~pbs_tpu_torch.gateway.chaos.draw_arrival` follows.

    Reactive shape state (the retry-storm backlog, per-tenant
    submit/shed books the scorer reads) lives on the instance: one
    instance per harness run, never reused.
    """

    def __init__(self, genome: Genome, tenants, ticks: int, seed: int,
                 n_gateways: int = 3):
        self.genome = genome
        self.ticks = max(1, int(ticks))
        self.order = [t.name for t in tenants]
        self.index = {name: i for i, name in enumerate(self.order)}
        n = len(self.order)
        g = genome
        # Misbehaving (spraying) tenants: a seeded choice, pure in
        # (genome, seed) — NOT "the first k" (that would alias the
        # region-skew split).
        rng = np.random.default_rng(
            derive_seed("spray", genome.digest(), seed))
        k = int(round(float(g["spray_frac"]) * n))
        self.spraying = set(
            int(i) for i in rng.choice(n, size=min(k, n), replace=False))
        # Oversized-but-legal batch cost: past the per-member lease
        # slice (burst/N) but never past the global burst — the borrow
        # path (gateway/federation.py), NOT the permanent
        # cost-over-burst shed — for the batch quota the harness
        # derives from the catalog contract (quota_for).
        from pbs_tpu_torch.gateway.chaos import quota_for

        batch_burst = float(quota_for("b", BATCH, 1).burst)
        self.oversize_cost = min(
            int(batch_burst),
            max(int(batch_burst // max(1, n_gateways)) + 1,
                int(0.8 * batch_burst)))
        self.pending_retries: dict[str, int] = {}
        self.submits: dict[str, int] = {}
        self.sheds: dict[str, int] = {}
        # draw() runs once per tick per tenant on the chaos hot path;
        # genes are immutable, so snapshot the ones it reads as plain
        # attributes instead of paying Genome.__getitem__'s linear
        # scan ~10 times per call.
        self._rate_i = float(g["rate_interactive"])
        self._rate_b = float(g["rate_batch"])
        self._diurnal_periods = int(g["diurnal_periods"])
        self._diurnal_amp = float(g["diurnal_amp"])
        self._flash_at = float(g["flash_at"])
        self._flash_len = float(g["flash_len"])
        self._flash_mult = float(g["flash_mult"])
        self._region_skew = float(g["region_skew"])
        self._longctx_at = float(g["longctx_at"])
        self._longctx_len = float(g["longctx_len"])
        self._longctx_mult = float(g["longctx_mult"])
        self._oversize_p = float(g["oversize_p"])
        self._retry_mult = int(g["retry_mult"])

    def _window(self, tick: int, at: float, length: float) -> bool:
        frac = tick / self.ticks
        return at <= frac < at + length

    def draw(self, t, tick: int, rng):
        u = float(rng.random())
        cost_i = 1 + int(rng.integers(0, 3))
        cost_b = 4 + int(rng.integers(0, 9))
        over = float(rng.random())

        i = self.index.get(t.name, 0)
        interactive = t.slo == INTERACTIVE
        p = self._rate_i if interactive else self._rate_b
        # Diurnal wave: the run is one day, genes set cycles/amplitude.
        # A TRIANGLE wave, deliberately: it is built from IEEE basic
        # ops only (bit-deterministic on every host), where sin()'s
        # last ulp varies across libm versions — and a one-ulp flip on
        # a fire threshold would make corpus golden digests
        # host-dependent.
        cycles = self._diurnal_periods * tick / self.ticks
        pos = cycles - math.floor(cycles)
        p *= 1.0 + self._diurnal_amp * (1.0 - 4.0 * abs(pos - 0.5))
        # Flash crowd window.
        if self._window(tick, self._flash_at, self._flash_len):
            p *= self._flash_mult
        # Multi-region skew: first half hot, second half cold.
        skew = self._region_skew
        if i < len(self.order) // 2:
            p *= 1.0 + skew
        else:
            p *= max(0.05, 1.0 - 0.8 * skew)
        # Misbehavior: spraying tenants ignore every shape and hammer.
        if i in self.spraying:
            p = 0.95
        fire = u < min(0.95, max(0.0, p))
        # Retry storm: a shed earlier turns into forced re-submission
        # pressure now (thundering herd after a front-door event).
        backlog = self.pending_retries.get(t.name, 0)
        if not fire and backlog > 0:
            self.pending_retries[t.name] = backlog - 1
            fire = True

        cost = cost_i if interactive else cost_b
        if not interactive:
            if self._window(tick, self._longctx_at, self._longctx_len):
                # Correlated long-context burst: every batch tenant's
                # cost inflates together (capped under the burst so
                # admission stays legal).
                cost = min(int(cost * self._longctx_mult), 100)
            if over < self._oversize_p:
                cost = self.oversize_cost
        if fire:
            self.submits[t.name] = self.submits.get(t.name, 0) + 1
        return fire, cost

    def note_result(self, tenant: str, tick: int,
                    admitted: bool) -> None:
        if not admitted:
            self.sheds[tenant] = self.sheds.get(tenant, 0) + 1
            mult = self._retry_mult
            if mult > 0:
                self.pending_retries[tenant] = \
                    self.pending_retries.get(tenant, 0) + mult

    def shed_asymmetry(self) -> float:
        """Max−min per-tenant shed fraction — the scorer's shed-
        asymmetry axis (a uniform overload sheds everyone equally;
        a pathological shape starves SOME tenants at the door)."""
        fracs = []
        for name in self.order:
            subs = self.submits.get(name, 0)
            if subs:
                fracs.append(self.sheds.get(name, 0) / subs)
        if not fracs:
            return 0.0
        return round(max(fracs) - min(fracs), _ROUND)
