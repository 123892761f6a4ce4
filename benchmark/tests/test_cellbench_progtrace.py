"""``benchmark.progtrace``: the program's phase spans joined to the device
trace. On synthetic records: attribution by correlation id, the
fallback for a record with no launch, idle split exactly over nested
spans, the clocks joined across a drifted anchor pair, the metrics and
the breakdown. Then each cell's traced CPU rehearsal with the phase
recorder attached: the program writes its phases, and with no device
record every metric reads None."""

import pytest

from benchmark import progtrace as P
from benchmark import spec
from benchmark.tests import tiny
from pbs_tpu_torch.obs import phases
from pbs_tpu_torch.obs.phases import PhaseSpan

SAME = P.ClockMap((0, 0), (1, 1))


def _span(name, t0, t1, depth=0, parent=-1, gc_ns=0):
    return PhaseSpan(name, 0, 0, t0, t1, depth, parent, 0, gc_ns,
                     1 if gc_ns else 0)


def _flat(spans):
    return [(s.name, s.t0, s.t1, s.depth, s.parent) for s in spans]


# outer [0, 100) holds inner [10, 40); top [120, 150) stands alone
NESTED = [_span("outer", 0, 100), _span("inner", 10, 40, 1, 0),
          _span("top", 120, 150)]


def test_device_time_goes_to_the_span_of_its_launch():
    device = [("k1", 60, 70, 1), ("k2", 75, 80, 2), ("k3", 130, 140, 3)]
    # k1 launched inside inner, k2 inside outer alone, k3 outside any
    launches = {1: 20, 2: 50, 3: 110}
    att = P.attribute(_flat(NESTED), device, launches, 0, 200)
    assert att["device_self"] == [5, 10, 0]
    assert att["device_in"] == [15, 10, 0]
    assert att["device_outside"] == 10
    assert att["unlaunched"] == 0


def test_a_record_with_no_launch_goes_by_its_start():
    device = [("k1", 20, 30, 7), ("k2", 125, 135, 8)]
    att = P.attribute(_flat(NESTED), device, {8: 5}, 0, 200)
    # k1 has no launch record: placed at its start, inside inner
    assert att["unlaunched"] == 1
    assert att["device_self"] == [10, 10, 0]


def test_idle_is_split_exactly_over_nested_spans():
    device = [("a", 40, 60, 1), ("b", 90, 130, 2)]
    att = P.attribute(_flat(NESTED), device, {1: 0, 2: 0}, 0, 200)
    # gaps [0, 40), [60, 90), [130, 200)
    assert att["idle_self"] == [10 + 30, 30, 20]
    assert att["idle_in"] == [70, 30, 20]
    assert att["idle_outside"] == 50
    assert att["busy_ns"] == 60
    total = sum(att["idle_self"]) + att["idle_outside"]
    assert total == att["window_ns"] - att["busy_ns"]


def test_overlapping_records_count_once_in_the_busy_union():
    device = [("a", 0, 50, 1), ("b", 20, 80, 2), ("c", 190, 260, 3)]
    att = P.attribute(_flat(NESTED), device, {}, 0, 200)
    # a record is clipped at the window's end, as devtrace.summarize does
    assert att["busy_ns"] == 80 + 10
    assert sum(att["idle_self"]) + att["idle_outside"] == 200 - 90


def test_clocks_join_across_a_drifted_anchor_pair():
    # the wall clock runs 10% fast against the monotonic one
    clock = P.ClockMap((1_000_000, 5_000_000), (2_000_000, 6_100_000))
    assert clock.drift_ns == 100_000
    assert clock(1_500_000) == 5_550_000
    micro = _span("train.micro", 1_800_000, 1_900_000)
    assert (clock(micro.t0), clock(micro.t1)) == (5_880_000, 5_990_000)
    harness = [("train_micro_step", 5_879_000, 5_991_000)]
    device = [("k", 5_990_500, 5_999_000, 1)]
    rep = P.report_from([micro], device, {1: 5_950_000}, harness, clock,
                        1_000_000, 2_000_000)
    assert rep["misaligned"] == 0
    assert rep["att"]["device_self"] == [8_500]
    # the start's offset alone puts the span 80 us early: misaligned,
    # and the launch falls outside it
    shifted = P.ClockMap((1_000_000, 5_000_000), (2_000_000, 6_000_000))
    rep = P.report_from([micro], device, {1: 5_950_000}, harness, shifted,
                        1_000_000, 2_000_000)
    assert rep["misaligned"] == 1
    assert rep["att"]["device_self"] == [0]


def test_anchor_reads_a_close_pair():
    import time

    m, w = P.anchor()
    assert abs((time.time_ns() - w) - (time.monotonic_ns() - m)) < 50_000_000


def _cell_report():
    """Two micro-steps (the second ends an optimizer step) and one
    engine tick over a 1,000 ns window."""
    spans = [
        _span("train.micro", 0, 300, gc_ns=2000),
        _span("train.backward", 50, 250, 1, 0),
        _span("train.micro", 300, 700, gc_ns=4000),
        _span("train.backward", 350, 500, 1, 2),
        _span("train.optimizer", 500, 650, 1, 2),
        _span("engine.tick", 700, 900),
        _span("engine.read", 750, 880, 1, 5),
    ]
    device = [("bwd", 100, 280, 1), ("bwd", 380, 520, 2),
              ("adam", 560, 640, 3), ("decode", 760, 800, 4)]
    launches = {1: 60, 2: 360, 3: 510, 4: 720}
    harness = [("train_micro_step", 0, 310), ("train_micro_step", 300, 710),
               ("engine_tick", 700, 900)]
    return P.report_from(spans, device, launches, harness, SAME, 0, 1000,
                         lost=0, records=14)


def test_the_metrics_read_the_report():
    rep = _cell_report()
    # micro idle: [0, 100) + [280, 300) in the first, [300, 380) + [520,
    # 560) + [640, 700) in the second (children's idle included)
    assert P.metric(rep, "micro_idle_ms") == (120 + 180) / 2 / 1e6
    assert P.metric(rep, "backward_device_ms") == (180 + 140) / 2 / 1e6
    assert P.metric(rep, "optimizer_device_ms") == 80 / 1e6
    # the tick: [700, 760) + [800, 900)
    assert P.metric(rep, "tick_idle_ms") == 160 / 1e6
    assert rep["misaligned"] == 0


def test_the_breakdown_names_phases_in_idle_gaps_shape():
    out = P.breakdown(_cell_report())
    assert set(out) == {"program_idle", "program_device", "program_clock",
                        "program_stalls"}
    idle = dict(out["program_idle"])
    assert idle["no_phase"] == 100 / 1e9  # [900, 1000)
    assert idle["engine.read"] == 90 / 1e9  # [750, 760) + [800, 880)
    assert sum(idle.values()) == pytest.approx((1000 - 440) / 1e9)
    assert out["program_device"][0] == ["train.backward", 320 / 1e9]
    assert out["program_clock"] == {"drift_ns": 0, "misaligned": 0,
                                    "lost": 0, "records": 14,
                                    "unlaunched": 0}
    assert out["program_stalls"]["train.micro"] == {
        "spans": 2, "gc_pause_s": 6000 / 1e9, "gc_runs": 2}


def test_profiler_records_on_the_host():
    """A host-only session: the harness's spans on the profiler's clock,
    and no device record or launch."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    start = P.anchor()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("train_micro_step"):
            torch.ones(64).add_(1)
        with record_function("not_a_harness_span"):
            pass
    stop = P.anchor()
    device, launches, harness = P.profiler_records(prof)
    assert (device, launches) == ([], {})
    assert [h[0] for h in harness] == ["train_micro_step"]
    # the profiler's clock is the wall clock the anchors read
    assert start[1] - 1_000_000 <= harness[0][1] <= harness[0][2] \
        <= stop[1] + 1_000_000
    assert time.time_ns() >= stop[1]


def test_no_device_record_no_report():
    assert P.report_from(NESTED, [], {}, [], SAME, 0, 100) is None
    assert all(P.metric(None, m) is None for m in P.METRICS)
    assert P.breakdown(None) == {}


#: Phases each cell's window must hold.
CELL_PHASES = {
    "colo.mistral-7b.serve-train": {
        "train.micro", "train.feed", "train.forward", "train.backward",
        "train.accumulate", "train.optimizer", "engine.tick",
        "engine.admit", "engine.prefill", "engine.decode", "engine.read",
        "engine.emit", "exec.timers", "exec.pick", "exec.account"},
    "colo.mixtral-8x7b.serve-score": {
        "engine.tick", "engine.prefill", "engine.read", "moe.route",
        "moe.experts", "moe.combine", "exec.pick", "exec.account"},
    "train.mistral-7b": {
        "train.micro", "train.backward", "train.optimizer", "exec.pick",
        "exec.account"},
}


@pytest.mark.parametrize("workload", sorted(CELL_PHASES))
def test_traced_rehearsal_records_phases_and_reads_none(workload):
    import torch

    from benchmark.harness import run_cell

    torch.set_num_threads(1)
    w = spec.workload(spec.benchmark(), workload)
    rec = phases.attach(phases.PhaseRecorder())
    start = P.anchor()
    try:
        result, run = run_cell(spec.benchmark(), workload, 20260101, 1.5,
                               True, "cpu",
                               cfg_override=tiny.config(w["config"]),
                               mix_override=tiny.mix(workload),
                               check_output=False)
    finally:
        phases.detach()
    stop = P.anchor()
    spans = phases.pair(rec.drain(), rec.names)
    assert rec.lost == 0
    assert CELL_PHASES[workload] <= {s.name for s in spans}
    rep = P.report_from(spans, [], {}, [], P.ClockMap(start, stop), run.t0,
                        run.t_closed)
    assert rep is None
    assert all(P.metric(rep, m) is None for m in P.METRICS)
    assert "breakdown" not in result
