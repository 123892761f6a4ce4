"""Typed knob registry: the port of ``pbs_tpu.knobs.registry``.

Every tunable is declared here once: name, kind, unit, safe range,
default, doc and (where the reference's C sim core marshals it) the
native ABI symbol, declaration for declaration the reference's, so an
unconfigured port schedules exactly as an unconfigured ``pbs_tpu``
does. The consuming modules derive their constants from the
declaration::

    from pbs_tpu_torch import knobs
    TSLICE_MIN_US = knobs.default("sched.feedback.tslice_min_us")

Two names of the reference are not declared (``UNDECLARED``): its
roofline peaks (``telemetry.source.peak_flops``/``peak_hbm_bw``) are
those of the accelerator it models, and ``CudaBackend`` states the
card's own.

Live values ride a process-local overlay (``set_local``/``get``) and
the file-backed channel (``knobs.channel``); tuned profiles map onto
these names through ``knobs.profile``. Stdlib only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable

# Inlined time factors (utils/clock.py values). The registry is the
# single module allowed to restate them: importing utils.clock here
# would put the registry below it in the import order, and every
# subsystem above BOTH.
_US = 1_000
_MS = 1_000_000
_SEC = 1_000_000_000

#: Unit vocabulary. Time units match the ``_ns/_us/_ms`` name-suffix
#: convention the time-units pass enforces; the rest are dimensional
#: annotations the suffix checker ignores.
UNITS = ("ns", "us", "ms", "s", "", "per_s", "tokens", "records",
         "steps", "flop_per_s", "bytes_per_s")

SUBSYSTEMS = ("sched", "gateway", "federation", "telemetry", "obs",
              "runtime", "dist", "autopilot", "scenarios", "journal",
              "serve", "hwtelem")


class KnobError(ValueError):
    """A knob push/declaration that violates the registry contract.

    Carries every problem of the batch (``problems``): an atomic push
    reports ALL its violations, then applies nothing.
    """

    def __init__(self, problems: list[str]):
        self.problems = list(problems)
        super().__init__("; ".join(self.problems))


@dataclasses.dataclass(frozen=True)
class Knob:
    """One declared tunable."""

    name: str  # dotted: "<subsystem>.<module>.<knob>"
    kind: str  # "int" | "float"
    unit: str  # see UNITS
    default: int | float
    lo: int | float  # safe range (inclusive)
    hi: int | float
    subsystem: str
    doc: str = ""
    #: C-ABI marshalling symbol in sim/native_core.py +
    #: runtime/csrc/pbst_runtime.cc (GS_*/GF_*), or None for a knob the
    #: native sim core deliberately does not model. The knob-discipline
    #: pass holds both sides to this declaration.
    native: str | None = None

    def coerce(self, value: Any) -> int | float:
        """Validate + convert one raw value; raises KnobError."""
        problems = check_value(self, value)
        if problems:
            raise KnobError(problems)
        return int(value) if self.kind == "int" else float(value)

    def as_dict(self) -> dict[str, Any]:
        d = {
            "name": self.name, "kind": self.kind, "unit": self.unit,
            "default": self.default, "lo": self.lo, "hi": self.hi,
            "subsystem": self.subsystem,
        }
        if self.doc:
            d["doc"] = self.doc
        if self.native:
            d["native"] = self.native
        return d


def check_value(knob: Knob, value: Any) -> list[str]:
    """The problems (empty = none) with assigning ``value`` to
    ``knob``. Shared by direct sets, channel pushes, and profile
    loads, so "malformed" and "out-of-range" mean the same thing on
    every path."""
    n = knob.name
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return [f"{n}: {value!r} is not a number"]
    if isinstance(value, float) and not math.isfinite(value):
        return [f"{n}: {value!r} is not finite"]
    if knob.kind == "int" and isinstance(value, float) \
            and value != int(value):
        return [f"{n}: {value!r} is not an integer "
                f"(declared kind: int)"]
    v = int(value) if knob.kind == "int" else float(value)
    if not (knob.lo <= v <= knob.hi):
        return [f"{n}: {v!r} outside safe range "
                f"[{knob.lo}, {knob.hi}] ({knob.unit or 'unitless'})"]
    return []


_REGISTRY: dict[str, Knob] = {}

#: The reference's declarations the port leaves out (see the module
#: docstring). A knob channel written by the reference carries them;
#: ``knobs.channel`` keeps their slots and hides their values.
UNDECLARED = ("telemetry.source.peak_flops", "telemetry.source.peak_hbm_bw")

#: Cross-knob constraints an atomic push must also satisfy: every
#: (lo_knob, hi_knob) pair must end with lo <= hi after the push.
BAND_PAIRS: tuple[tuple[str, str], ...] = (
    ("sched.feedback.tslice_min_us", "sched.feedback.tslice_max_us"),
    ("sched.atc.tslice_min_us", "sched.atc.tslice_max_us"),
    ("sched.base.tslice_min_us", "sched.base.tslice_max_us"),
    ("sched.credit.tslice_min_bound_us", "sched.credit.tslice_max_bound_us"),
    ("sched.sedf.period_min_us", "sched.sedf.period_max_us"),
    ("sched.feedback.stable_lo", "sched.feedback.stable_hi"),
    ("dist.rpc.backoff_base_s", "dist.rpc.backoff_cap_s"),
)


def _declare(name: str, kind: str, unit: str, default, lo, hi,
             doc: str = "", native: str | None = None) -> None:
    subsystem = name.split(".", 1)[0]
    problems: list[str] = []
    if subsystem not in SUBSYSTEMS:
        problems.append(f"{name}: unknown subsystem {subsystem!r}")
    if unit not in UNITS:
        problems.append(f"{name}: unknown unit {unit!r}")
    if name in _REGISTRY:
        problems.append(f"{name}: declared twice")
    # The declared unit and the name's own suffix must agree — the
    # registry holds itself to the convention it enforces on consumers.
    leaf = name.rsplit(".", 1)[-1]
    for suf in ("ns", "us", "ms"):
        if leaf.endswith("_" + suf) and unit != suf:
            problems.append(f"{name}: name suffix _{suf} vs declared "
                            f"unit {unit!r}")
    if problems:
        raise KnobError(problems)
    knob = Knob(name=name, kind=kind, unit=unit, default=default,
                lo=lo, hi=hi, subsystem=subsystem, doc=doc,
                native=native)
    bad = check_value(knob, default)
    if bad:
        raise KnobError([f"{name}: default invalid: {b}" for b in bad])
    _REGISTRY[name] = knob


# ---------------------------------------------------------------------------
# Declarations. Defaults ARE the former module literals — an
# unconfigured tree is bit-identical to the pre-registry one (every
# golden digest is the witness).
# ---------------------------------------------------------------------------

# -- sched.feedback: the research-core adaptation loop (sched/feedback.py)
_declare("sched.feedback.metric_tick_period_ns", "int", "ns",
         1 * _MS, 100 * _US, 1 * _SEC,
         doc="CSCHED_METRIC_TICK_PERIOD (sched_credit.c:55)")
_declare("sched.feedback.window", "int", "",
         5, 1, 128,
         doc="event filter window depth (sched_credit.c:114); hi is "
             "native_core.MAX_WINDOW",
         native="GS_WINDOW_LEN")
_declare("sched.feedback.stable_lo", "float", "",
         0.70, 0.0, 1.0,
         doc="stability band lower factor (sched_credit.c:354-357)")
_declare("sched.feedback.stable_hi", "float", "",
         1.30, 1.0, 10.0,
         doc="stability band upper factor")
_declare("sched.feedback.stall_threshold", "float", "",
         100.0, 0.0, 1e6,
         doc="HBM-stall phase threshold (100 = 10% of device time)",
         native="GF_STALL_THRESHOLD")
_declare("sched.feedback.tslice_min_us", "int", "us",
         100, 10, 1_000_000,
         doc="adaptation band floor (sched_credit.c:286-300)",
         native="GS_MIN_US")
_declare("sched.feedback.tslice_max_us", "int", "us",
         1_100, 10, 1_000_000,
         doc="adaptation band cap of the built variant",
         native="GS_MAX_US")
_declare("sched.feedback.grow_step_us", "int", "us",
         100, 1, 100_000,
         doc="LOW_PHASE slice growth per stable window",
         native="GS_GROW_STEP_US")
_declare("sched.feedback.shrink_sub_us", "int", "us",
         200, 1, 100_000,
         doc="HIGH_PHASE subtractive shrink when cur//3 under-floors",
         native="GS_SHRINK_SUB_US")
_declare("sched.feedback.qdelay_threshold_ns", "int", "ns",
         2 * _MS, 1, 1 * _SEC,
         doc="gateway queue-delay per-event threshold (py-only: the "
             "native sim core has no gateway in the loop)")
_declare("sched.feedback.gw_hot_after", "int", "",
         3, 1, 100,
         doc="consecutive over-threshold reports before BOOST+shrink "
             "(py-only: no gateway in the native sim core)")

# -- sched.atc: the atc quantum law (sched/atc.py)
_declare("sched.atc.alpha", "int", "",
         4, 1, 64, doc="EWMA weight (sched_credit_atc.c ALPHA)")
_declare("sched.atc.history", "int", "",
         4, 1, 64, doc="state-history hysteresis depth")
_declare("sched.atc.slice_base_us", "int", "us",
         49_980, 1, 1_000_000, doc="linear law intercept (atc:336-347)")
_declare("sched.atc.slice_step_us", "int", "us",
         3_300, 1, 1_000_000, doc="per-bucket decrement")
_declare("sched.atc.tslice_min_us", "int", "us",
         300, 10, 1_000_000, doc="atc band floor")
_declare("sched.atc.tslice_max_us", "int", "us",
         30_000, 10, 1_000_000,
         doc="atc band cap — the paper's 30 ms upper band edge")

# -- sched.base: the dispatch-legal envelope (sched/base.py)
_declare("sched.base.tslice_min_us", "int", "us",
         100, 1, 1_000_000,
         doc="outer clamp floor every do_schedule applies")
_declare("sched.base.tslice_max_us", "int", "us",
         1_000_000, 1, 10_000_000,
         doc="outer clamp cap (sysctl UMAX, public/sysctl.h:571)")

# -- sched.credit (sched/credit.py)
_declare("sched.credit.acct_period_us", "int", "us",
         30_000, 1_000, 1_000_000,
         doc="CSCHED_ACCT_PERIOD (sched_credit.c:50)")
_declare("sched.credit.tslice_min_bound_us", "int", "us",
         1_000, 1, 1_000_000, doc="sysctl UMIN (public/sysctl.h:570)")
_declare("sched.credit.tslice_max_bound_us", "int", "us",
         1_000_000, 1, 10_000_000, doc="sysctl UMAX")

# -- sched.credit2 (sched/credit2.py)
_declare("sched.credit2.credit_init", "float", "",
         10_000.0, 1.0, 1e9,
         doc="starting credit (credit units ≈ µs at the runqueue's "
             "max weight — a currency, not a clock reading, so no "
             "time-suffix contract)")
_declare("sched.credit2.reset_threshold", "float", "",
         0.0, -1e9, 1e9,
         doc="credit level that triggers a reset epoch "
             "(CSCHED2_CREDIT_RESET)")
_declare("sched.credit2.tickle_margin", "float", "",
         500.0, 0.0, 1e9,
         doc="preemption margin in credit units")
_declare("sched.credit2.balance_every", "int", "",
         16, 1, 1_000_000, doc="load-balance cadence in schedule calls")
_declare("sched.credit2.balance_threshold", "float", "",
         1.0, 0.0, 1e9, doc="EWMA load delta that justifies a steal")
_declare("sched.credit2.load_alpha", "float", "",
         0.125, 0.0, 1.0, doc="runqueue load EWMA weight")
_declare("sched.credit2.default_weight", "int", "",
         256, 1, 65_536, doc="credit2 default job weight")
_declare("sched.credit2.carry_frac", "float", "",
         0.5, 0.0, 1.0, doc="credit carried across a reset epoch")

# -- sched.sedf (sched/sedf.py)
_declare("sched.sedf.extra_quantum_ns", "int", "ns",
         500 * _US, 1_000, 1 * _SEC,
         doc="EXTRA_QUANTUM (sched_sedf.c:40)")
_declare("sched.sedf.weight_period_us", "int", "us",
         100_000, 1_000, 10_000_000, doc="MILLISECS(100)")
_declare("sched.sedf.weight_safety_us", "int", "us",
         5_000, 0, 1_000_000, doc="MILLISECS(5) headroom")
_declare("sched.sedf.period_min_us", "int", "us",
         10, 1, 1_000_000, doc="PERIOD_MIN")
_declare("sched.sedf.period_max_us", "int", "us",
         10_000_000, 1_000, 100_000_000, doc="PERIOD_MAX")
_declare("sched.sedf.slice_min_us", "int", "us",
         5, 1, 1_000_000, doc="SLICE_MIN")

# -- sched.arinc653 (sched/arinc653.py)
_declare("sched.arinc653.default_window_us", "int", "us",
         10_000, 100, 10_000_000,
         doc="default per-job minor-frame window")

# -- gateway.admission (gateway/admission.py)
_declare("gateway.admission.default_rate", "float", "per_s",
         100.0, 0.001, 1e9,
         doc="TenantQuota default sustained cost-units/s")
_declare("gateway.admission.default_burst", "float", "tokens",
         50.0, 0.001, 1e9, doc="TenantQuota default bucket capacity")
_declare("gateway.admission.default_weight", "int", "",
         256, 1, 65_536, doc="TenantQuota default fair-queue share")
_declare("gateway.admission.default_max_queued", "int", "",
         64, 1, 1_000_000,
         doc="TenantQuota default per-tenant queue-slot bound")
_declare("gateway.admission.max_queued_total", "int", "",
         256, 1, 10_000_000, doc="gateway-wide queue bound")
_declare("gateway.admission.shed_retry_ns", "int", "ns",
         50 * _MS, 1 * _MS, 60 * _SEC,
         doc="retry-after hint for transient sheds (queue pressure)")
_declare("gateway.admission.permanent_retry_ns", "int", "ns",
         1 * _SEC, 1 * _MS, 3_600 * _SEC,
         doc="retry-after hint for permanent conditions "
             "(unknown-tenant, cost-over-burst)")
_declare("gateway.admission.rate_scale", "float", "",
         1.0, 0.01, 100.0,
         doc="live multiplier on every tenant's mint rate — the "
             "hot-reloadable global throttle (docs/KNOBS.md); applied "
             "by LeaseBroker.set_rate_scale at the next settle")

# -- gateway.fairqueue (gateway/fairqueue.py)
_declare("gateway.fairqueue.drr_quantum", "int", "tokens",
         16, 1, 1_000_000,
         doc="deficit top-up per DRR visit at weight 256")
_declare("gateway.fairqueue.interactive_slots", "int", "",
         4, 1, 64, doc="interactive share of the class dispatch cycle")
_declare("gateway.fairqueue.batch_slots", "int", "",
         1, 1, 64, doc="batch floor share of the class dispatch cycle")

# -- gateway.gateway (gateway/gateway.py)
_declare("gateway.gateway.feedback_period_ns", "int", "ns",
         10 * _MS, 1 * _MS, 60 * _SEC,
         doc="queue-delay feedback export cadence")

# -- gateway.federation (gateway/federation.py)
_declare("gateway.federation.renew_period_ns", "int", "ns",
         4 * _MS, 1 * _MS, 60 * _SEC,
         doc="lease renewal cadence")
_declare("gateway.federation.lease_ttl_ns", "int", "ns",
         6 * _MS, 1 * _MS, 120 * _SEC,
         doc="lease validity; deliberately < 2 renew periods")
_declare("gateway.federation.no_gateway_retry_ns", "int", "ns",
         50 * _MS, 1 * _MS, 60 * _SEC,
         doc="retry-after when every front door is dead/partitioned")
_declare("gateway.federation.partition_heal_ns", "int", "ns",
         20 * _MS, 1 * _MS, 60 * _SEC,
         doc="default gateway.partition fault duration before heal")

# -- federation.proc (gateway/procfed.py, gateway/supervisor.py):
# process-mode deployment, where each member is a real OS process.
# Wall-clock-facing (heartbeats and restarts ride the host scheduler),
# so floors are generous for a loaded 1-vCPU box.
_declare("federation.proc.heartbeat_ns", "int", "ns",
         50 * _MS, 1 * _MS, 60 * _SEC,
         doc="supervisor heartbeat cadence per member process")
_declare("federation.proc.miss_budget", "int", "",
         3, 1, 100,
         doc="consecutive missed heartbeats before a member is "
             "declared SUSPECT and restarted")
_declare("federation.proc.restart_backoff_ns", "int", "ns",
         100 * _MS, 1 * _MS, 300 * _SEC,
         doc="base restart backoff; doubles per consecutive restart")
_declare("federation.proc.max_restarts", "int", "",
         3, 0, 100,
         doc="restart budget before a member is drained from the "
             "ring and its queued work handed off")
_declare("federation.proc.rpc_deadline_ns", "int", "ns",
         2 * _SEC, 10 * _MS, 600 * _SEC,
         doc="whole-call rpc deadline (incl. retries) for every "
             "parent->member op; timeouts shed with retry-after")

# -- runtime (runtime/doorbell.py, runtime/executor.py)
_declare("runtime.doorbell.poll_ns", "int", "ns",
         500 * _US, 1 * _US, 1 * _SEC,
         doc="doorbell poll period when no waiter is armed")
_declare("runtime.executor.max_steps_per_quantum", "int", "steps",
         1024, 1, 1_000_000,
         doc="quantum_to_steps ceiling — bounds a quantum's compiled "
             "step count whatever the slice band says")

# -- obs.trace (obs/trace.py EmitBatch watermarks)
_declare("obs.trace.emit_batch_capacity", "int", "records",
         256, 1, 1_000_000,
         doc="EmitBatch size watermark (staged records per flush)")
_declare("obs.trace.emit_batch_flush_ns", "int", "ns",
         1 * _MS, 1 * _US, 60 * _SEC,
         doc="EmitBatch time watermark over staged event timestamps")

# -- dist.rpc backoff envelope (dist/rpc.py)
_declare("dist.rpc.max_retries", "int", "",
         3, 0, 100, doc="bounded transport retries per call")
_declare("dist.rpc.backoff_base_s", "float", "s",
         0.005, 0.0001, 60.0, doc="exponential backoff base")
_declare("dist.rpc.backoff_cap_s", "float", "s",
         0.05, 0.0001, 600.0, doc="exponential backoff cap")
_declare("dist.rpc.timeout_s", "float", "s",
         5.0, 0.001, 3_600.0, doc="socket timeout per attempt")

# -- autopilot: the shadow-replay self-tuning loop (pbs_tpu/autopilot/)
_declare("autopilot.min_record_ns", "int", "ns",
         80 * _MS, 1 * _MS, 3_600 * _SEC,
         doc="shadow-trace capture horizon before the first candidate "
             "search (docs/AUTOPILOT.md)")
_declare("autopilot.guard_window_ns", "int", "ns",
         60 * _MS, 1 * _MS, 3_600 * _SEC,
         doc="canary guard window: how long SLO burn is watched "
             "before promote-or-rollback")
_declare("autopilot.burn_limit", "float", "",
         2.0, 0.0, 1e6,
         doc="per-tenant SLO burn rate at the canary members that "
             "trips automatic rollback (1.0 = exactly the error "
             "budget)")
_declare("autopilot.score_margin_x1e6", "int", "",
         5_000, 0, 1_000_000,
         doc="minimum tuned-frontier score margin (x1e6, the tune "
             "scale) a shadow candidate must beat the live config by "
             "before any rollout starts")
_declare("autopilot.canary_members", "int", "",
         1, 1, 64,
         doc="how many federation members receive a candidate as a "
             "scoped canary push")
_declare("autopilot.min_guard_samples", "int", "",
         5, 1, 1_000_000,
         doc="minimum completed requests per tenant at the canary "
             "members before its burn rate counts as evidence")
_declare("autopilot.switch_cost_ns", "int", "ns",
         100 * _US, 0, 10 * _MS,
         doc="first-order context-switch overhead of the serving-tier "
             "profile model: adopting a band with cap C us inflates "
             "member service time by 1 + switch_cost/(C us) — the "
             "paper's short-slice overhead applied at the member "
             "(0 = model off). At the reference band (cap 1.1 ms) "
             "this is ~9% overhead; at the pathological collapsed "
             "10 us band it is ~11x, which is what the canary guard "
             "must catch")

# -- scenarios: the coverage-guided adversarial frontier search
# (pbs_tpu/scenarios/; docs/SCENARIOS.md). Declared here so a hunt is
# tunable with `pbst knobs set` instead of code edits, and so the
# knob-discipline pass owns these constants like every other loop's.
_declare("scenarios.hunt.population", "int", "",
         8, 1, 256,
         doc="candidate genomes evaluated per hunt generation")
_declare("scenarios.hunt.generations", "int", "",
         4, 1, 1024,
         doc="hunt generations (evaluate -> admit -> breed rounds)")
_declare("scenarios.hunt.mutation_rate", "float", "",
         0.35, 0.0, 1.0,
         doc="per-gene perturbation probability of the mutate "
             "operator (at least one gene always moves)")
_declare("scenarios.hunt.crossover_rate", "float", "",
         0.5, 0.0, 1.0,
         doc="probability a child is bred by elite crossover instead "
             "of elite mutation")
_declare("scenarios.hunt.archive_buckets", "int", "",
         6, 2, 64,
         doc="behavior-signature buckets per stress axis (the "
             "MAP-Elites grid resolution)")
_declare("scenarios.hunt.archive_max", "int", "",
         64, 1, 10_000,
         doc="elite-archive bound; lowest-stress entries are evicted "
             "past it (evictions are logged, never silent)")
_declare("scenarios.score.w_burn", "float", "",
         1.0, 0.0, 100.0,
         doc="stress weight: worst per-tenant SLO burn rate "
             "(normalized b/(1+b))")
_declare("scenarios.score.w_fairness", "float", "",
         1.0, 0.0, 100.0,
         doc="stress weight: Jain fairness collapse (1 - jain) under "
             "the sim harness")
_declare("scenarios.score.w_slack", "float", "",
         1.0, 0.0, 100.0,
         doc="stress weight: lease-audit slack (conservative spend "
             "fraction of all token-backed spend)")
_declare("scenarios.score.w_gap", "float", "",
         0.5, 0.0, 100.0,
         doc="stress weight: span-gap proximity (custody transfers — "
             "handoffs+requeues — per admitted request)")
_declare("scenarios.score.w_shed", "float", "",
         0.5, 0.0, 100.0,
         doc="stress weight: shed asymmetry (max-min per-tenant shed "
             "fraction spread at the front door)")

# -- journal: the gateway's write-ahead intent journal
# (gateway/journal.py; docs/DURABILITY.md). Group-commit watermarks,
# durability cadence, and the lease-book checkpoint period.
_declare("journal.batch_capacity", "int", "records",
         256, 1, 1_000_000,
         doc="EmitBatch size watermark of the journal staging path "
             "(staged intent records per in-memory flush; disk sees "
             "one frame per commit regardless)")
_declare("journal.flush_ns", "int", "ns",
         1 * _MS, 1 * _US, 60 * _SEC,
         doc="EmitBatch time watermark over staged intent timestamps")
_declare("journal.fsync_every", "int", "",
         0, 0, 1_000_000,
         doc="fsync cadence in commits (0 = never fsync: page-cache "
             "durability, survives kill-9 but not power loss; 1 = "
             "every group commit)")
_declare("journal.checkpoint_period_ns", "int", "ns",
         20 * _MS, 1 * _MS, 3_600 * _SEC,
         doc="sealed lease-book checkpoint cadence (CKPT/CKPT_SEAL "
             "groups recovery reconciles the broker books against)")

# -- serve: the sharded serving backend + prefill/decode
# disaggregation (pbs_tpu/serve; docs/SERVING.md). Declared here so
# the autopilot can canary serving knobs exactly like scheduler ones.
_declare("serve.backend.decode_slots", "int", "",
         4, 1, 64,
         doc="decode slots of a ShardedServeBackend's engine "
             "(concurrent requests holding KV-cache lanes; one decode "
             "token per lane per gateway tick)")
_declare("serve.disagg.pool_split_ratio", "float", "",
         0.25, 0.05, 0.75,
         doc="fraction of a disaggregated backend's slot budget owned "
             "by the prefill pool (the rest decodes); the prefill/"
             "decode topology knob of docs/SERVING.md")
_declare("serve.disagg.prefill_chunk_tokens", "int", "tokens",
         64, 8, 4096,
         doc="prompt tokens the prefill pool may ingest per gateway "
             "tick (admission-side backpressure: long-context prompts "
             "cannot starve decode of a pump quantum)")
_declare("serve.disagg.kv_handoff_batch", "int", "",
         2, 1, 64,
         doc="prefilled requests handed from the prefill pool to the "
             "decode pool per tick (each handoff moves one prompt "
             "window of KV and emits one SPAN_HANDOFF)")

# -- telemetry.source hardware model: not declared here. The reference
# declares its modelled accelerator's roofline peaks; the port's
# ``CudaBackend`` states the peaks of the card it runs on instead
# (telemetry/source.py), so the two names stay undeclared (UNDECLARED).

# -- hwtelem live counter plane (pbs_tpu/hwtelem; docs/HWTELEM.md)
_declare("hwtelem.sample_period_ns", "int", "ns",
         10 * _MS, 100 * _US, 10 * _SEC,
         doc="nominal ladder sampling period for live recorders (the "
             "gateway hw pump and `pbst hw record` tick at this "
             "cadence; recorded windows carry the value they were "
             "driven at)")
_declare("hwtelem.window_len", "int", "records",
         4096, 16, 1 << 20,
         doc="HwRecorder ring capacity in samples: a long-lived "
             "recorder overwrites its oldest capture past this "
             "(dropped is counted, the shadow-ring retention rule)")
_declare("hwtelem.stale_threshold", "int", "",
         3, 1, 100,
         doc="consecutive dead hw samples (progress without device "
             "time) a FeedbackPolicy.from_source policy tolerates "
             "before parking the tslice at its fallback — the "
             "stale_after the live-counter path runs with")
_declare("hwtelem.fidelity_margin_floor", "float", "",
         0.25, 0.0, 1.0,
         doc="max tolerated per-axis relative error between the sim "
             "prediction and the live measurement before the "
             "fidelity report (docs/HWTELEM.md) fails; margin = "
             "floor - worst axis error")


# ---------------------------------------------------------------------------
# Accessors
# ---------------------------------------------------------------------------

#: Process-local overlay: live (hot-reloaded) values. Import-time
#: constants read ``default()`` and stay frozen; live consumers read
#: ``get()`` or subscribe through knobs.channel.KnobWatcher.
_current: dict[str, int | float] = {}


def knob(name: str) -> Knob:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KnobError([f"unknown knob {name!r}"]) from None


def exists(name: str) -> bool:
    return name in _REGISTRY


def default(name: str) -> int | float:
    """The declared default — what the former module literal was."""
    return knob(name).default


def get(name: str) -> int | float:
    """Current live value (default unless hot-reloaded)."""
    k = knob(name)
    return _current.get(name, k.default)


def all_knobs() -> list[Knob]:
    return [_REGISTRY[n] for n in sorted(_REGISTRY)]


def names() -> list[str]:
    return sorted(_REGISTRY)


def snapshot() -> dict[str, int | float]:
    """Every knob's current live value, sorted by name."""
    return {n: get(n) for n in sorted(_REGISTRY)}


def validate_set(updates: dict[str, Any],
                 base: dict[str, int | float] | None = None
                 ) -> dict[str, int | float]:
    """Validate a whole push; returns the coerced updates or raises
    :class:`KnobError` carrying EVERY problem — the atomicity
    contract's first half (the second is that callers apply the
    returned dict all-or-nothing). ``base`` is the value set the push
    lands on (defaults: the declaration defaults) for cross-knob band
    checks."""
    problems: list[str] = []
    coerced: dict[str, int | float] = {}
    if not isinstance(updates, dict) or not updates:
        raise KnobError(["push carries no knob=value updates"])
    for name in sorted(updates):
        if not isinstance(name, str) or name not in _REGISTRY:
            problems.append(f"unknown knob {name!r}")
            continue
        k = _REGISTRY[name]
        bad = check_value(k, updates[name])
        if bad:
            problems.extend(bad)
            continue
        coerced[name] = (int(updates[name]) if k.kind == "int"
                         else float(updates[name]))

    def effective(n: str):
        if n in coerced:
            return coerced[n]
        if base is not None and n in base:
            return base[n]
        return _REGISTRY[n].default

    if not problems:
        for lo_name, hi_name in BAND_PAIRS:
            if lo_name in coerced or hi_name in coerced:
                lo, hi = effective(lo_name), effective(hi_name)
                if lo > hi:
                    problems.append(
                        f"band inverted: {lo_name}={lo} > "
                        f"{hi_name}={hi}")
    if problems:
        raise KnobError(problems)
    return coerced


def set_local(updates: dict[str, Any]) -> dict[str, int | float]:
    """Atomic process-local apply: validate everything, then apply
    everything (or nothing). Returns the coerced updates."""
    coerced = validate_set(updates, base=snapshot())
    _current.update(coerced)
    return coerced


def reset_local() -> None:
    """Test hook: drop every hot-reloaded value."""
    _current.clear()


def schema() -> dict[str, Any]:
    """JSON-stable declaration dump (``pbst knobs list --json``)."""
    return {
        "version": 1,
        "knobs": [k.as_dict() for k in all_knobs()],
    }
