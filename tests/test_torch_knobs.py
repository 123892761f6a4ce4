"""The port's typed knob registry, knob channel, tuned profiles and the
feedback policy's knob surface against ``pbs_tpu``'s.

- The registry: knob by knob, every declaration of the reference's is
  the port's (name, kind, unit, range, default, doc, native symbol),
  and the only names the port leaves out are the reference's two
  roofline peaks.
- The cases of ``tests/test_knobs.py`` (but the CLI's, the lease
  broker's and the native-symbol file check, whose subjects are not
  ported) and of ``tests/test_feedback.py``/``test_feedback_clamp.py``
  (but the simulator-engine ones) run as functions of a package
  namespace on both packages: each makes the reference test's own
  assertions, and the two runs' observables must be equal, with the
  two undeclared knobs taken out of the reference's views and the
  scratch directories out of the messages.
- The channel file: after the same pushes the port's file and sidecars
  are byte for byte the reference's (over the same knob set), and a
  file either package writes is read, watched and pushed by the other.
  Canary-scoped pushes interoperate: the port reads a scope sidecar the
  reference wrote and the reference reads the port's, and member
  watchers of either package adopt exactly their canary set.
- Tuned profiles: all five load through ``policy_from_profile`` into
  the same policy, which then steers a seeded run slice for slice like
  the reference's.
"""

from __future__ import annotations

import importlib
import json
import os
import threading
import types

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

import torch  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

MS = 1_000_000


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    rt, tel = mod("runtime"), mod("telemetry")
    return types.SimpleNamespace(
        root=root, knobs=mod("knobs"), registry=mod("knobs.registry"),
        channel=mod("knobs.channel"), profile=mod("knobs.profile"),
        tune=mod("sched.tune"), fbmod=mod("sched.feedback"),
        sched=mod("sched"), rt=rt, tel=tel, Job=rt.Job,
        Partition=rt.Partition, SchedParams=rt.SchedParams,
        SimBackend=tel.SimBackend, SimProfile=tel.SimProfile,
        SimPhase=tel.SimPhase)


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")
UNDECLARED = set(PORT.registry.UNDECLARED)


@pytest.fixture(autouse=True)
def _clean_overlay():
    for K in (REF, PORT):
        K.knobs.reset_local()
    yield
    for K in (REF, PORT):
        K.knobs.reset_local()


def _strip(obj):
    """The reference's view without the two knobs the port leaves
    undeclared."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in UNDECLARED}
    if isinstance(obj, (list, tuple)):
        return [_strip(v) for v in obj]
    return obj


def _twin(case, tmp_path):
    """Run a case on both packages, each in its own scratch directory;
    the observables must be equal."""
    out = {}
    for tag, K in (("ref", REF), ("port", PORT)):
        d = tmp_path / tag
        d.mkdir()
        got = json.dumps(_strip(case(K, d)), sort_keys=True, default=str)
        out[tag] = got.replace(str(d), "<tmp>")
    assert out["port"] == out["ref"]


def _raises(exc, fn, match=None) -> str:
    with pytest.raises(exc, match=match) as e:
        fn()
    return f"{type(e.value).__name__}: {e.value}"


# -- the registry -------------------------------------------------------


REF_KNOBS = [k.name for k in REF.knobs.all_knobs()]


@pytest.mark.parametrize("name", REF_KNOBS)
def test_registry_declaration_parity(name):
    if name in UNDECLARED:
        assert not PORT.knobs.exists(name)
        _raises(PORT.knobs.KnobError, lambda: PORT.knobs.knob(name),
                match="unknown knob")
        return
    assert PORT.knobs.knob(name).as_dict() == REF.knobs.knob(name).as_dict()
    assert PORT.knobs.default(name) == REF.knobs.default(name)
    assert PORT.knobs.get(name) == REF.knobs.get(name)


def test_registry_difference_is_exactly_the_two_peaks():
    ref, port = set(REF.knobs.names()), set(PORT.knobs.names())
    assert ref - port == {"telemetry.source.peak_flops",
                          "telemetry.source.peak_hbm_bw"}
    assert port <= ref
    assert PORT.knobs.BAND_PAIRS == REF.knobs.BAND_PAIRS
    assert PORT.registry.UNITS == REF.registry.UNITS
    assert PORT.registry.SUBSYSTEMS == REF.registry.SUBSYSTEMS
    assert [k for k in REF.knobs.schema()["knobs"]
            if k["name"] not in UNDECLARED] == PORT.knobs.schema()["knobs"]
    assert sorted(PORT.knobs.__all__) == sorted(REF.knobs.__all__)


# -- tests/test_knobs.py ------------------------------------------------


def k_defaults_are_the_former_literals(K, d):
    kn = K.knobs
    assert kn.default("sched.feedback.tslice_min_us") == 100
    assert kn.default("sched.feedback.tslice_max_us") == 1_100
    assert kn.default("sched.feedback.window") == 5
    assert kn.default("sched.atc.tslice_max_us") == 30_000
    assert kn.default("gateway.admission.default_rate") == 100.0
    assert kn.default("gateway.federation.renew_period_ns") == 4_000_000
    assert kn.default("runtime.doorbell.poll_ns") == 500_000
    assert kn.default("obs.trace.emit_batch_capacity") == 256
    assert kn.default("dist.rpc.max_retries") == 3
    return kn.snapshot()


def k_every_declaration_is_self_consistent(K, d):
    for k in K.knobs.all_knobs():
        assert k.lo <= k.default <= k.hi, k.name
        assert k.subsystem == k.name.split(".", 1)[0]
        leaf = k.name.rsplit(".", 1)[-1]
        for suf in ("ns", "us", "ms"):
            if leaf.endswith("_" + suf):
                assert k.unit == suf, k.name
    return [k.as_dict() for k in K.knobs.all_knobs()
            if k.name not in UNDECLARED]


def k_unknown_and_malformed_and_out_of_range(K, d):
    kn = K.knobs
    first = _raises(kn.KnobError, lambda: kn.knob("no.such.knob"))
    text = _raises(kn.KnobError, lambda: kn.validate_set({
        "sched.feedback.window": "banana",
        "sched.feedback.tslice_min_us": 5,
        "no.such.knob": 1,
    }))
    assert "banana" in text and "outside safe range" in text \
        and "no.such.knob" in text
    return [first, text]


def k_band_pair_rejection_and_set_local_atomicity(K, d):
    kn = K.knobs
    band = _raises(kn.KnobError, lambda: kn.validate_set(
        {"sched.feedback.tslice_min_us": 5_000}), match="band inverted")
    atomic = _raises(kn.KnobError, lambda: kn.set_local(
        {"sched.feedback.grow_step_us": 50,
         "sched.feedback.window": 10**9}))
    assert kn.get("sched.feedback.grow_step_us") == 100
    assert kn.set_local({"sched.feedback.grow_step_us": 50}) == {
        "sched.feedback.grow_step_us": 50}
    assert kn.get("sched.feedback.grow_step_us") == 50
    assert kn.default("sched.feedback.grow_step_us") == 100
    return [band, atomic, kn.snapshot()]


def k_int_knob_rejects_fractions_and_bools(K, d):
    kn = K.knobs
    w = kn.knob("sched.feedback.window")
    out = [kn.check_value(w, v) for v in (1.5, True, float("nan"), 6.0)]
    assert out[0] and out[1] and out[2] and not out[3]
    return out


def k_channel_roundtrip_and_generation(K, d):
    path = str(d / "knobs.led")
    ch = K.channel.KnobChannel.create(path)
    gen0, vals = ch.snapshot()
    assert gen0 == 0
    assert vals == K.knobs.snapshot()
    assert ch.push({"sched.feedback.tslice_min_us": 200}) == 1
    ro = K.channel.KnobChannel.attach(path)
    gen, vals = ro.snapshot()
    assert gen == 1
    assert vals["sched.feedback.tslice_min_us"] == 200
    assert isinstance(vals["sched.feedback.tslice_min_us"], int)
    assert isinstance(vals["gateway.admission.rate_scale"], float)
    return [gen, vals]


def k_rejected_push_is_atomic_bytes_identical(K, d):
    path = str(d / "knobs.led")
    ch = K.channel.KnobChannel.create(path)
    ch.push({"sched.feedback.grow_step_us": 150})
    before = open(path, "rb").read()
    msgs = []
    for bad in (
        {"sched.feedback.window": "banana"},
        {"gateway.admission.rate_scale": 1e9},
        {"sched.feedback.grow_step_us": 50, "no.such.knob": 1},
        {"sched.feedback.tslice_min_us": 5_000},
        {},
    ):
        msgs.append(_raises(K.knobs.KnobError, lambda: ch.push(bad)))
    assert open(path, "rb").read() == before
    assert ch.generation == 1
    return msgs


def k_wedged_channel_refuses_push_and_create_recovers(K, d):
    """The reference recovers through ``pbst knobs init``, which is a
    fresh ``KnobChannel.create``; the port has no CLI for it yet."""
    path = str(d / "knobs.led")
    ch = K.channel.KnobChannel.create(path)
    ch.push({"sched.feedback.grow_step_us": 150})
    ch._store(2, ch._words(2, 1)[0] + 1)
    wedged = _raises(K.knobs.KnobError, lambda: ch.push(
        {"sched.feedback.grow_step_us": 50}), match="wedged")
    torn = _raises(K.knobs.KnobError, lambda: K.channel.KnobChannel.attach(
        path).snapshot(max_retries=4), match="retries exhausted")
    K.channel.KnobChannel.create(path)
    gen, vals = K.channel.KnobChannel.attach(path).snapshot()
    assert gen == 0 and vals == K.knobs.snapshot()
    return [wedged, torn, gen]


def k_reader_attach_cannot_push(K, d):
    path = str(d / "knobs.led")
    K.channel.KnobChannel.create(path)
    ro = K.channel.KnobChannel.attach(path)
    return _raises(K.knobs.KnobError, lambda: ro.push(
        {"sched.feedback.grow_step_us": 50}), match="read-only")


def k_channel_poll_and_watcher_applies_changes(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    watcher = K.channel.KnobWatcher(K.channel.KnobChannel.attach(path))
    seen: list[dict] = []
    watcher.add(lambda changed, values: seen.append(dict(changed)))
    assert watcher.poll() is None
    w.push({"gateway.admission.rate_scale": 0.5})
    w.push({"sched.feedback.window": 3})
    changed = watcher.poll()
    assert changed == {"gateway.admission.rate_scale": 0.5,
                       "sched.feedback.window": 3}
    assert seen == [changed]
    assert watcher.poll() is None
    return [seen, watcher.applied]


def k_channel_poll_is_none_when_idle(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    ro = K.channel.KnobChannel.attach(path)
    assert ro.poll(0) is None
    w.push({"sched.feedback.window": 4})
    gen, vals = ro.poll(0)
    assert gen == 1 and vals["sched.feedback.window"] == 4
    assert ro.poll(gen) is None
    return [gen, vals]


def k_watcher_push_of_current_value_is_an_empty_change(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    watcher = K.channel.KnobWatcher(K.channel.KnobChannel.attach(path))
    w.push({"sched.feedback.window": K.knobs.default(
        "sched.feedback.window")})
    assert watcher.poll() == {}
    assert watcher.applied == 1
    assert watcher.poll() is None
    return watcher.applied


def k_watcher_appliers_see_changes_and_full_view(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    watcher = K.channel.KnobWatcher(K.channel.KnobChannel.attach(path))
    calls = []
    watcher.add(lambda ch, vals: calls.append(("a", dict(ch), len(vals))))
    watcher.add(lambda ch, vals: calls.append(("b", dict(ch),
                                               vals["sched.feedback.window"])))
    w.push({"sched.feedback.window": 3})
    watcher.poll()
    w.push({"sched.feedback.grow_step_us": 50})
    watcher.poll()
    assert [c[0] for c in calls] == ["a", "b", "a", "b"]
    assert calls[3] == ("b", {"sched.feedback.grow_step_us": 50}, 3)
    return [c[:2] for c in calls]


def k_two_watchers_on_one_channel_are_independent(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    r = K.channel.KnobChannel.attach(path)
    wa, wb = K.channel.KnobWatcher(r), K.channel.KnobWatcher(r)
    w.push({"sched.feedback.window": 3})
    assert wa.poll() == {"sched.feedback.window": 3}
    w.push({"sched.feedback.grow_step_us": 50})
    got_b = wb.poll()
    assert got_b == {"sched.feedback.window": 3,
                     "sched.feedback.grow_step_us": 50}
    assert wa.poll() == {"sched.feedback.grow_step_us": 50}
    return [wa.applied, wb.applied, got_b]


def k_watch_loop_bounded(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    ro = K.channel.KnobChannel.attach(path)
    w.push({"sched.feedback.window": 4})
    events = []
    n = ro.watch(lambda gen, vals: events.append(gen),
                 timeout_s=1.0, poll_interval_s=0.01, max_events=1)
    assert n == 1 and events == [1]  # initial snapshot = current truth
    # Nothing new: without the initial emission, timeout returns clean.
    assert ro.watch(lambda *_: None, timeout_s=0.05,
                    poll_interval_s=0.01, initial=False) == 0
    return [n, events]


def k_scoped_push_writes_scope_sidecar_and_clears_on_global(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    w.push({"sched.feedback.tslice_max_us": 2000}, scope=["gw0", "gw1"])
    first = w.knob_scopes()
    assert first == {"sched.feedback.tslice_max_us": ["gw0", "gw1"]}
    # A global push of the same knob clears its scope (promote path);
    # untouched scoped knobs keep theirs.
    w.push({"sched.feedback.window": 3}, scope=["gw2"])
    w.push({"sched.feedback.tslice_max_us": 2000})
    assert w.knob_scopes() == {"sched.feedback.window": ["gw2"]}
    return [first, w.knob_scopes(), open(path + ".scope.json").read()]


def k_scoped_push_empty_member_set_rejected(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    gen = w.generation
    msg = _raises(K.knobs.KnobError,
                  lambda: w.push({"sched.feedback.window": 3}, scope=[]))
    assert w.generation == gen  # rejection atomic, as ever
    return [msg, os.path.exists(path + ".scope.json")]


def k_member_watcher_filters_scoped_push(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    r = K.channel.KnobChannel.attach(path)
    wa = K.channel.KnobWatcher(r, member="gw0")
    wb = K.channel.KnobWatcher(r, member="gw1")
    anon = K.channel.KnobWatcher(r)  # anonymous watcher: scoped = foreign
    w.push({"sched.feedback.tslice_max_us": 2000}, scope=["gw0"])
    got = [wa.poll(), wb.poll(), anon.poll()]
    assert got == [{"sched.feedback.tslice_max_us": 2000}, {}, {}]
    assert wb.skipped == 1 and anon.skipped == 1
    return [got, wa.skipped, wb.skipped, anon.skipped]


def k_canary_scoping_regression_no_silent_readoption(K, d):
    """A canary-scoped push adopted by gw0 must NOT leak into gw1
    through the shared file when a later UNRELATED global push moves
    the generation."""
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    r = K.channel.KnobChannel.attach(path)
    wa = K.channel.KnobWatcher(r, member="gw0")
    wb = K.channel.KnobWatcher(r, member="gw1")
    w.push({"sched.feedback.tslice_max_us": 2000}, scope=["gw0"])
    log = [wa.poll(), wb.poll()]
    assert "sched.feedback.tslice_max_us" in log[0]
    assert log[1] == {}
    w.push({"sched.feedback.window": 3})
    got = wb.poll()
    assert got == {"sched.feedback.window": 3}
    # Promotion: a global push of the SAME file value re-delivers it
    # to gw1 (scope cleared => changed vs gw1's own view).
    w.push({"sched.feedback.tslice_max_us": 2000})
    log += [got, wb.poll()]
    assert log[-1] == {"sched.feedback.tslice_max_us": 2000}
    log.append(wa.poll())
    assert log[-1] == {"sched.feedback.window": 3}
    assert wa.poll() is None
    return log


def k_rollback_push_restores_only_canary_members(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    r = K.channel.KnobChannel.attach(path)
    adopted = {"gw0": {}, "gw1": {}}
    wa = K.channel.KnobWatcher(r, member="gw0")
    wa.add(lambda ch, vals: adopted["gw0"].update(ch))
    wb = K.channel.KnobWatcher(r, member="gw1")
    wb.add(lambda ch, vals: adopted["gw1"].update(ch))
    ref_min = int(K.knobs.default("sched.feedback.tslice_min_us"))
    ref_max = int(K.knobs.default("sched.feedback.tslice_max_us"))
    w.push({"sched.feedback.tslice_min_us": 10,
            "sched.feedback.tslice_max_us": 10}, scope=["gw0"])
    wa.poll(), wb.poll()
    assert adopted["gw0"]["sched.feedback.tslice_max_us"] == 10
    assert adopted["gw1"] == {}
    w.push({"sched.feedback.tslice_min_us": ref_min,
            "sched.feedback.tslice_max_us": ref_max})  # rollback
    wa.poll(), wb.poll()
    assert adopted["gw0"]["sched.feedback.tslice_max_us"] == ref_max
    assert adopted["gw1"] == {}  # never touched — truly scoped
    return adopted


def k_watcher_prime_delivers_current_applicable_state(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    w.push({"sched.feedback.window": 7}, scope=["gw9"])
    r = K.channel.KnobChannel.attach(path)
    seen = {}
    watcher = K.channel.KnobWatcher(r, member="gw0")
    watcher.add(lambda ch, vals: seen.update(ch))
    primed = watcher.prime()
    assert primed["sched.feedback.tslice_max_us"] == \
        K.knobs.default("sched.feedback.tslice_max_us")
    assert "sched.feedback.window" not in primed
    assert seen == primed
    return primed


def k_appliers_never_see_foreign_scoped_values(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    r = K.channel.KnobChannel.attach(path)
    seen_values = {}
    wb = K.channel.KnobWatcher(r, member="gw1")
    wb.add(lambda ch, vals: seen_values.update(vals))
    w.push({"sched.feedback.tslice_min_us": 10,
            "sched.feedback.tslice_max_us": 10}, scope=["gw0"])
    w.push({"sched.feedback.grow_step_us": 50})  # unrelated, global
    wb.poll()
    assert seen_values["sched.feedback.grow_step_us"] == 50
    assert "sched.feedback.tslice_max_us" not in seen_values
    return seen_values


def k_skipped_counts_filtered_deliveries_not_generations(K, d):
    path = str(d / "knobs.led")
    w = K.channel.KnobChannel.create(path)
    r = K.channel.KnobChannel.attach(path)
    wb = K.channel.KnobWatcher(r, member="gw1")
    w.push({"sched.feedback.tslice_min_us": 10,
            "sched.feedback.tslice_max_us": 10}, scope=["gw0"])
    wb.poll()
    assert wb.skipped == 2
    w.push({"sched.feedback.grow_step_us": 50})
    wb.poll()
    assert wb.skipped == 2  # foreign values persisted, no new delivery
    return wb.skipped


def k_channel_meta_sidecar_guards_attach(K, d):
    path = str(d / "knobs.led")
    K.channel.KnobChannel.create(path)
    meta_path = path + ".meta.json"
    meta = json.load(open(meta_path))
    meta["knobs"].append({"name": "not.a.knob", "kind": "int", "unit": ""})
    json.dump(meta, open(meta_path, "w"))
    a = _raises(K.knobs.KnobError, lambda: K.channel.KnobChannel.attach(
        path), match="does not declare")
    os.remove(meta_path)
    b = _raises(K.knobs.KnobError, lambda: K.channel.KnobChannel.attach(
        path), match="sidecar")
    return [a, b]


def k_every_checked_in_profile_roundtrips(K, d):
    out = {}
    for wl in K.tune.tuned_workloads():
        prof = K.tune.load_profile(wl)
        params = dict(prof["params"])
        assert K.profile.roundtrip_params(prof["policy"], params) == params
        out[wl] = [prof, K.profile.profile_knob_document(prof)]
    assert sorted(out) == sorted(K.tune.TUNED_WORKLOADS)
    return out


def k_param_mapping_covers_tunable_params_exactly(K, d):
    PK = K.profile.PARAM_KNOBS
    assert set(PK["feedback"]) == set(K.sched.FeedbackPolicy.TUNABLE_PARAMS)
    assert set(PK["atc"]) == set(K.sched.AtcFeedbackPolicy.TUNABLE_PARAMS)
    for policy, mapping in PK.items():
        for knob_name in mapping.values():
            assert K.knobs.exists(knob_name), (policy, knob_name)
    return [PK, K.sched.FeedbackPolicy.TUNABLE_PARAMS,
            K.sched.FeedbackPolicy.KNOB_POLICY,
            K.sched.AtcFeedbackPolicy.KNOB_POLICY]


def k_out_of_range_profile_fails_loudly(K, d):
    a = _raises(K.knobs.KnobError, lambda: K.profile.params_to_knobs(
        "feedback", {"min_us": 1}), match="outside safe range")
    b = _raises(K.knobs.KnobError, lambda: K.profile.params_to_knobs(
        "feedback", {"warp_factor": 9}), match="no declared knob")
    c = _raises(K.knobs.KnobError, lambda: K.profile.params_to_knobs(
        "nosuch", {}), match="no knob mapping")
    return [a, b, c]


def _policy_setup(K, tslice_us=500):
    be = K.SimBackend()
    part = K.Partition("t", source=be, scheduler="credit")
    fb = K.sched.FeedbackPolicy(part)
    be.register("w", K.SimProfile.steady(step_time_ns=100_000,
                                         stall_frac=0.5,
                                         collective_wait_ns=1_000))
    job = K.Job("w", params=K.SchedParams(tslice_us=tslice_us),
                max_steps=10_000_000)
    job.contexts[0].avg_step_ns = 100_000
    part.add_job(job)
    return part, fb, job


def _fb_view(fb) -> dict:
    return {k: getattr(fb, k) for k in (
        "min_us", "max_us", "window_len", "stall_threshold",
        "grow_step_us", "shrink_sub_us", "qdelay_threshold_ns",
        "gw_hot_after", "stale_after", "fallback_us", "hw_source")}


def k_apply_knobs_reclamps_live_jobs_and_rejects_inverted_band(K, d):
    part, fb, job = _policy_setup(K, tslice_us=900)
    applied = fb.apply_knobs({"sched.feedback.tslice_min_us": 200,
                              "sched.feedback.tslice_max_us": 400,
                              "sched.feedback.window": 3})
    assert applied == {"min_us": 200, "max_us": 400, "window": 3}
    assert (fb.min_us, fb.max_us, fb.window_len) == (200, 400, 3)
    assert job.params.tslice_us == 400
    before = (fb.min_us, fb.max_us)
    inverted = _raises(K.knobs.KnobError, lambda: fb.apply_knobs(
        {"sched.feedback.tslice_min_us": 500}), match="band inverted")
    assert (fb.min_us, fb.max_us) == before
    assert fb.apply_knobs({"gateway.admission.rate_scale": 0.5}) == {}
    return [applied, inverted, _fb_view(fb), job.params.tslice_us]


def k_live_band_push_steers_a_running_policy(K, d):
    part, fb, job = _policy_setup(K, tslice_us=200)
    path = str(d / "knobs.led")
    writer = K.channel.KnobChannel.create(path)
    watcher = K.channel.KnobWatcher(K.channel.KnobChannel.attach(path))
    watcher.add(lambda changed, _vals: fb.apply_knobs(changed))
    part.timers.arm(1_000_000, lambda now: watcher.poll(),
                    period_ns=1_000_000, name="knob_watch")
    part.run(until_ns=200_000_000)
    assert job.params.tslice_us == 1_100
    writer.push({"sched.feedback.tslice_min_us": 200,
                 "sched.feedback.tslice_max_us": 2_000})
    part.run(until_ns=400_000_000)
    assert fb.max_us == 2_000
    assert job.params.tslice_us == 2_000
    assert watcher.applied >= 1
    return [_fb_view(fb), fb.dump(), part.dump(), watcher.applied]


def k_from_knobs_builds_policy_from_channel_surface(K, d):
    part = K.Partition("t2", source=K.SimBackend(), scheduler="credit")
    fb = K.sched.FeedbackPolicy.from_knobs(part, {
        "sched.feedback.tslice_min_us": 200,
        "sched.feedback.tslice_max_us": 2_000,
        "sched.feedback.window": 3,
    })
    assert (fb.min_us, fb.max_us, fb.window_len) == (200, 2_000, 3)
    return _fb_view(fb)


def k_from_profile_rejects_unknown_params(K, d):
    part = K.Partition("t3", source=K.SimBackend(), scheduler="credit")
    bad = _raises(KeyError, lambda: K.sched.FeedbackPolicy.from_profile(
        part, {"params": {"min_us": 200, "warp": 1}}))
    fb = K.sched.FeedbackPolicy.from_profile(part, {"min_us": 300})
    return [bad, _fb_view(fb)]


KNOB_CASES = [
    k_defaults_are_the_former_literals,
    k_every_declaration_is_self_consistent,
    k_unknown_and_malformed_and_out_of_range,
    k_band_pair_rejection_and_set_local_atomicity,
    k_int_knob_rejects_fractions_and_bools,
    k_channel_roundtrip_and_generation,
    k_rejected_push_is_atomic_bytes_identical,
    k_wedged_channel_refuses_push_and_create_recovers,
    k_reader_attach_cannot_push,
    k_channel_poll_and_watcher_applies_changes,
    k_channel_poll_is_none_when_idle,
    k_watcher_push_of_current_value_is_an_empty_change,
    k_watcher_appliers_see_changes_and_full_view,
    k_two_watchers_on_one_channel_are_independent,
    k_watch_loop_bounded,
    k_scoped_push_writes_scope_sidecar_and_clears_on_global,
    k_scoped_push_empty_member_set_rejected,
    k_member_watcher_filters_scoped_push,
    k_canary_scoping_regression_no_silent_readoption,
    k_rollback_push_restores_only_canary_members,
    k_watcher_prime_delivers_current_applicable_state,
    k_appliers_never_see_foreign_scoped_values,
    k_skipped_counts_filtered_deliveries_not_generations,
    k_channel_meta_sidecar_guards_attach,
    k_every_checked_in_profile_roundtrips,
    k_param_mapping_covers_tunable_params_exactly,
    k_out_of_range_profile_fails_loudly,
    k_apply_knobs_reclamps_live_jobs_and_rejects_inverted_band,
    k_live_band_push_steers_a_running_policy,
    k_from_knobs_builds_policy_from_channel_surface,
    k_from_profile_rejects_unknown_params,
]


@pytest.mark.parametrize("case", KNOB_CASES, ids=lambda c: c.__name__)
def test_knob_case_twin(case, tmp_path):
    _twin(case, tmp_path)


@pytest.mark.parametrize("tier", [False, "ctypes", True],
                         ids=["python", "ctypes", "native"])
def test_channel_snapshot_never_tears_under_live_writer(tmp_path, tier):
    """The reference's soak, shortened: a writer pushing band updates
    while a reader snapshots; every snapshot is one pushed state and
    the generation is monotone. The writer also publishes to a ledger
    on each of its tiers between pushes, as a partition does, so the
    threads interleave as each tier lets them (ctypes releases the GIL
    inside C, fastcall does not); that ledger never tears either."""
    import numpy as np

    from pbs_tpu_torch.runtime import native
    from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS
    from pbs_tpu_torch.telemetry.ledger import Ledger

    if tier and not native.available():
        pytest.skip(f"native runtime unavailable: "
                    f"{native.unavailable_reason()}")
    led = Ledger(1, native=tier)
    one = np.ones(NUM_COUNTERS, dtype=np.uint64)
    path = str(tmp_path / "knobs.led")
    w = PORT.channel.KnobChannel.create(path)
    ro = PORT.channel.KnobChannel.attach(path)
    pairs = [(100 + i, 1_100 + i) for i in range(100)]
    stop = threading.Event()

    def writer():
        for lo, hi in pairs:
            w.push({"sched.feedback.tslice_min_us": lo,
                    "sched.feedback.tslice_max_us": hi})
            led.add_many(0, one)
        stop.set()

    legal = {(100, 1_100), *pairs}
    torn, last_gen = [], -1
    t = threading.Thread(target=writer)
    t.start()
    while not stop.is_set():
        gen, vals = ro.snapshot()
        pair = (vals["sched.feedback.tslice_min_us"],
                vals["sched.feedback.tslice_max_us"])
        if pair not in legal:
            torn.append((gen, pair))
        assert gen >= last_gen
        last_gen = gen
        row = led.snapshot(0)
        assert (row == row[0]).all()
    t.join()
    assert torn == []
    assert ro.generation == len(pairs)
    assert int(led.snapshot(0)[0]) == len(pairs)


# -- the channel file across packages -----------------------------------


PUSHES = [
    {"sched.feedback.tslice_max_us": 700},
    {"sched.feedback.tslice_min_us": 200, "sched.feedback.window": 3,
     "gateway.admission.rate_scale": 0.25},
    {"sched.atc.tslice_max_us": 9_000},
    {"sched.feedback.stable_hi": 1.5, "sched.credit2.carry_frac": 0.25},
    {"sched.atc.tslice_max_us": 9_000},
]


def _files(path: str) -> dict:
    out = {}
    for suffix in ("", ".meta.json", ".scope.json"):
        p = path + suffix
        if os.path.exists(p):
            out[suffix] = open(p, "rb").read()
    return out


def _push_all(ch) -> list:
    return [ch.push(upd) for upd in PUSHES]


def test_channel_files_are_byte_identical_over_one_knob_set(tmp_path,
                                                            monkeypatch):
    """Over the same knob set (the reference's registry without the two
    peaks the port leaves undeclared), the same pushes leave the same
    bytes: the value file and the meta sidecar."""
    reduced = {n: k for n, k in REF.registry._REGISTRY.items()
               if n not in UNDECLARED}
    monkeypatch.setattr(REF.registry, "_REGISTRY", reduced)
    paths = {tag: str(tmp_path / f"{tag}.led") for tag in ("ref", "port")}
    gens = {}
    for tag, K in (("ref", REF), ("port", PORT)):
        gens[tag] = _push_all(K.channel.KnobChannel.create(paths[tag]))
    assert gens["port"] == gens["ref"] == [1, 2, 3, 4, 5]
    ref_files, port_files = _files(paths["ref"]), _files(paths["port"])
    assert sorted(port_files) == ["", ".meta.json"]
    assert port_files == ref_files


def test_port_pushes_into_a_reference_channel_byte_for_byte(tmp_path):
    """A channel the reference created (its whole registry, the two
    peaks included): the port attaches as the writer and pushes; the
    file ends byte for byte where the reference's own pushes leave a
    twin of it, and the peaks' slots are kept but hidden."""
    paths = {tag: str(tmp_path / f"{tag}.led") for tag in ("ref", "port")}
    for p in paths.values():
        REF.channel.KnobChannel.create(p)
    _push_all(REF.channel.KnobChannel.attach(paths["ref"], writable=True))
    port_w = PORT.channel.KnobChannel.attach(paths["port"], writable=True)
    assert len(port_w.names) == len(REF.knobs.names())
    _push_all(port_w)
    assert _files(paths["port"]) == _files(paths["ref"])
    gen, vals = port_w.snapshot()
    ref_gen, ref_vals = REF.channel.KnobChannel.attach(paths["ref"]).snapshot()
    assert gen == ref_gen == len(PUSHES)
    assert vals == _strip(ref_vals)
    assert set(ref_vals) - set(vals) == UNDECLARED
    for name in UNDECLARED:
        _raises(PORT.knobs.KnobError, lambda: port_w.get(name),
                match="unknown knob")
        _raises(PORT.knobs.KnobError, lambda: port_w.push({name: 1e15}),
                match="unknown knob")
    assert _files(paths["port"]) == _files(paths["ref"])


def test_each_package_watches_the_others_pushes(tmp_path):
    """A push from either package is delivered by the other's watcher,
    with the same changed sets."""
    for writer_pkg, reader_pkg in ((PORT, REF), (REF, PORT)):
        path = str(tmp_path / f"{writer_pkg.root}.led")
        w = writer_pkg.channel.KnobChannel.create(path)
        seen = {}
        for K in (REF, PORT):
            ch = K.channel.KnobChannel.attach(path)
            seen[K.root] = (K.channel.KnobWatcher(ch), [])
        for upd in PUSHES:
            w.push(upd)
            for K in (REF, PORT):
                watcher, log = seen[K.root]
                log.append(watcher.poll())
        ref_log = _strip(seen[REF.root][1])
        assert _strip(seen[PORT.root][1]) == ref_log, (writer_pkg.root,
                                                       reader_pkg.root)
        assert seen[PORT.root][0].applied == seen[REF.root][0].applied


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_scoped_channels_interoperate_across_packages(writer, tmp_path):
    """A canary-scoped push written by either package: the scope sidecar
    is the same bytes, the other package reads it, and each package's
    member watchers adopt exactly the canary set, with the same changed
    sets, skips and primed views; a global push of the same value then
    promotes it to every member of both packages."""
    W = {"ref": REF, "port": PORT}[writer]
    path = str(tmp_path / "knobs.led")
    w = W.channel.KnobChannel.create(path)
    twin = str(tmp_path / "twin.led")
    REF.channel.KnobChannel.create(twin).push(
        {"sched.feedback.tslice_max_us": 2000}, scope=["gw0", "gw2"])
    watchers = {K.root: {m: K.channel.KnobWatcher(
        K.channel.KnobChannel.attach(path), member=m)
        for m in ("gw0", "gw1", "gw2")} for K in (REF, PORT)}
    w.push({"sched.feedback.tslice_max_us": 2000}, scope=["gw2", "gw0"])
    assert open(path + ".scope.json", "rb").read() == \
        open(twin + ".scope.json", "rb").read()
    for K in (REF, PORT):
        ch = K.channel.KnobChannel.attach(path)
        assert ch.knob_scopes() == {
            "sched.feedback.tslice_max_us": ["gw0", "gw2"]}
    log = {}
    for K in (REF, PORT):
        got = {m: wt.poll() for m, wt in watchers[K.root].items()}
        assert got == {"gw0": {"sched.feedback.tslice_max_us": 2000},
                       "gw1": {}, "gw2": {"sched.feedback.tslice_max_us":
                                          2000}}
        late = K.channel.KnobWatcher(K.channel.KnobChannel.attach(path),
                                     member="gw1")
        primed = _strip(late.prime())
        # A late joiner outside the canary starts from the channel's
        # applicable truth: the scoped knob stays foreign to it.
        assert "sched.feedback.tslice_max_us" not in primed
        assert primed["sched.feedback.window"] == \
            K.knobs.default("sched.feedback.window")
        log[K.root] = [got, {m: wt.skipped
                             for m, wt in watchers[K.root].items()}, primed]
    assert log[PORT.root] == log[REF.root]
    w.push({"sched.feedback.tslice_max_us": 2000})  # promotion
    for K in (REF, PORT):
        assert K.channel.KnobChannel.attach(path).knob_scopes() == {}
        assert [wt.poll() for wt in watchers[K.root].values()] == [
            {}, {"sched.feedback.tslice_max_us": 2000}, {}]


# -- tuned profiles through policy_from_profile --------------------------


def _profile_run(K, workload):
    be = K.SimBackend(seed=5)
    part = K.Partition("p", source=be, scheduler="credit", n_executors=2)
    fb = K.tune.policy_from_profile(part, workload)
    Phase, Profile = K.SimPhase, K.SimProfile
    jobs = [
        (K.Job("mem", params=K.SchedParams(weight=512)),
         Profile.steady(step_time_ns=150_000, stall_frac=0.5,
                        collective_wait_ns=2_000, jitter=0.2)),
        (K.Job("comp", params=K.SchedParams(weight=256)),
         Profile.steady(step_time_ns=60_000, stall_frac=0.02,
                        collective_wait_ns=40_000, jitter=0.1)),
        (K.Job("phased", params=K.SchedParams(weight=256)),
         Profile([Phase(steps=600, step_time_ns=100_000, stall_frac=0.4,
                        collective_wait_ns=200_000, jitter=0.2),
                  Phase(steps=-1, step_time_ns=100_000, stall_frac=0.05,
                        jitter=0.1)])),
    ]
    for job, prof in jobs:
        be.register(job.name, prof)
        part.add_job(job)
    frames = []
    for i in range(1, 61):
        if i % 20 == 5:
            jobs[1][0].report_contention(80_000, events=2)
        part.run(until_ns=i * 5 * MS)
        frames.append([j.params.tslice_us for j, _ in jobs])
    return type(fb).__name__, _fb_view(fb), frames, fb.dump(), part.dump()


@pytest.mark.parametrize("workload", list(REF.tune.TUNED_WORKLOADS))
def test_policy_from_profile_twin(workload):
    """Each tuned workload's profile arms the same policy class with the
    same params, which then steers a seeded run slice for slice as the
    reference's does."""
    assert workload in PORT.tune.tuned_workloads()
    assert PORT.tune.load_profile(workload) == REF.tune.load_profile(workload)
    got = _profile_run(PORT, workload)
    want = _profile_run(REF, workload)
    assert got == want
    prof = PORT.tune.load_profile(workload)
    assert got[1]["min_us"] == prof["params"]["min_us"]
    assert got[1]["max_us"] == prof["params"]["max_us"]


def test_tune_search_waits_for_the_simulator():
    """The search scored on the simulator, which the port now has: a
    check block over the reference constants equals the reference's
    (``tests/test_torch_tune.py`` holds the rest of the search)."""
    params = dict(REF.tune.QUICK_SPACE["feedback"][0])
    got = PORT.tune.check_block("stable", "feedback", params, n_reps=1)
    want = REF.tune.check_block("stable", "feedback", params, n_reps=1)
    assert got.pop("tier") == want.pop("tier")
    assert got == want
    assert PORT.tune.TUNED_WORKLOADS == REF.tune.TUNED_WORKLOADS
    assert PORT.tune.PROFILE_VERSION == REF.tune.PROFILE_VERSION
    assert PORT.tune.profile_path("x", "/d") == REF.tune.profile_path(
        "x", "/d")
    with pytest.raises(ValueError, match="version"):
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "old.json"), "w") as f:
                json.dump({"version": 0}, f)
            PORT.tune.load_profile("old", d)


# -- tests/test_feedback.py and test_feedback_clamp.py -------------------


def _fb_setup(K, profile, tslice_us=500, max_steps=100_000, seed=0):
    be = K.SimBackend(seed=seed)
    part = K.Partition("t", source=be, scheduler="credit")
    fb = K.sched.FeedbackPolicy(part)
    be.register("w", profile)
    job = K.Job("w", params=K.SchedParams(tslice_us=tslice_us),
                max_steps=max_steps)
    job.contexts[0].avg_step_ns = profile.phases[0].step_time_ns
    part.add_job(job)
    return part, fb, job


def _fb_obs(part, fb, job) -> list:
    return [job.params.tslice_us, fb.dump(), part.dump(),
            job.contexts[0].counters.tolist()]


def f_memory_bound_phase_grows_slice(K, d):
    prof = K.SimProfile.steady(step_time_ns=100_000, stall_frac=0.5,
                               collective_wait_ns=1_000)
    part, fb, job = _fb_setup(K, prof, tslice_us=200)
    part.run(until_ns=200_000_000)
    assert job.params.tslice_us == K.fbmod.TSLICE_MAX_US
    assert fb.state_of(job).grows > 0
    return _fb_obs(part, fb, job)


def f_compute_phase_shrinks_slice(K, d):
    prof = K.SimProfile.steady(step_time_ns=100_000, stall_frac=0.01,
                               collective_wait_ns=1_000)
    part, fb, job = _fb_setup(K, prof, tslice_us=900)
    part.run(until_ns=200_000_000)
    assert job.params.tslice_us == K.fbmod.TSLICE_MIN_US
    assert fb.state_of(job).shrinks > 0
    return _fb_obs(part, fb, job)


def f_phase_transition_tracks(K, d):
    prof = K.SimProfile([
        K.SimPhase(steps=2000, step_time_ns=100_000, stall_frac=0.5,
                   collective_wait_ns=1_000),
        K.SimPhase(steps=-1, step_time_ns=100_000, stall_frac=0.01,
                   collective_wait_ns=1_000),
    ])
    part, fb, job = _fb_setup(K, prof, tslice_us=400)
    part.run(until_ns=150_000_000)
    grew_to = job.params.tslice_us
    assert grew_to > 400
    part.run(until_ns=600_000_000)
    assert job.params.tslice_us == K.fbmod.TSLICE_MIN_US
    return [grew_to, _fb_obs(part, fb, job)]


def _oscillating(K):
    phases = [K.SimPhase(steps=20, step_time_ns=100_000, stall_frac=0.3,
                         collective_wait_ns=100 if i % 2 == 0 else 1_000_000)
              for i in range(50)]
    phases.append(K.SimPhase(steps=-1, step_time_ns=100_000))
    return K.SimProfile(phases)


def f_unstable_contention_resets_window(K, d):
    part, fb, job = _fb_setup(K, _oscillating(K))
    part.run(until_ns=100_000_000)
    assert fb.state_of(job).resets > 0
    return _fb_obs(part, fb, job)


def f_contention_report_channel(K, d):
    prof = K.SimProfile.steady(step_time_ns=100_000, stall_frac=0.5)
    part, fb, job = _fb_setup(K, prof)
    job.report_contention(5_000, events=2)
    assert job.contention_wait_ns == 5_000
    w, e = job.take_contention()
    assert (w, e) == (5_000, 2)
    assert job.contention_wait_ns == 0
    return [w, e]


def f_bounds_respected(K, d):
    prof = K.SimProfile.steady(step_time_ns=100_000, stall_frac=0.9)
    part, fb, job = _fb_setup(K, prof, tslice_us=K.fbmod.TSLICE_MAX_US)
    part.run(until_ns=100_000_000)
    assert (K.fbmod.TSLICE_MIN_US <= job.params.tslice_us
            <= K.fbmod.TSLICE_MAX_US)
    return _fb_obs(part, fb, job)


def f_unstable_contention_resets_window_via_sim(K, d):
    part, fb, job = _fb_setup(K, _oscillating(K), seed=0)
    part.run(until_ns=100 * MS)
    assert fb.state_of(job).resets > 0
    assert (K.fbmod.TSLICE_MIN_US <= job.params.tslice_us
            <= K.fbmod.TSLICE_MAX_US)
    return _fb_obs(part, fb, job)


def f_shrink_clamps_overshoot_above_cap(K, d):
    part = K.Partition("t", source=K.SimBackend(), scheduler="credit")
    fb = K.sched.FeedbackPolicy(part)
    job = K.Job("j", params=K.SchedParams(tslice_us=5_000))
    st = K.fbmod.JobMetricState()
    fb._shrink(job, st)
    assert job.params.tslice_us == K.fbmod.TSLICE_MAX_US
    job.params.tslice_us = 0
    fb._grow(job, st)
    assert job.params.tslice_us >= K.fbmod.TSLICE_MIN_US
    return job.params.tslice_us


def f_adversarial_contention_never_escapes_band(K, d):
    """The reference reads every tick from its run recorder; the port
    has none, so the run is cut into 1 ms chunks (one metric tick each)
    and the slice is read after each."""
    import numpy as np

    rng = np.random.default_rng(42)
    be = K.SimBackend(seed=1)
    part = K.Partition("t", source=be, scheduler="credit")
    fb = K.sched.FeedbackPolicy(part)
    phases = []
    for _ in range(60):
        phases.append(K.SimPhase(
            steps=int(rng.integers(5, 20)),
            step_time_ns=int(rng.integers(50, 200)) * 1000,
            stall_frac=float(rng.uniform(0.0, 0.9)),
            collective_wait_ns=int(rng.integers(0, 500_000))))
    phases.append(K.SimPhase(steps=-1, step_time_ns=100_000, stall_frac=0.5,
                             collective_wait_ns=1_000))
    be.register("adv", K.SimProfile(phases))
    job = K.Job("adv", params=K.SchedParams(tslice_us=400), max_steps=10**9)
    job.contexts[0].avg_step_ns = 100_000.0
    part.add_job(job)
    ticks = []

    def run_for(ns):
        end = part.clock.now_ns() + ns
        while part.clock.now_ns() < end:
            part.run(until_ns=min(end, part.clock.now_ns() + MS))
            ticks.append(job.params.tslice_us)

    injected = (5_000, 1, 3_333, 50)
    for value in injected:
        run_for(50 * MS)
        job.params.tslice_us = value
    run_for(200 * MS)
    lo, hi = K.fbmod.TSLICE_MIN_US, K.fbmod.TSLICE_MAX_US
    for prev, cur in zip(ticks, ticks[1:]):
        if cur != prev:
            assert lo <= cur <= hi or cur in injected, (prev, cur)
    assert lo <= job.params.tslice_us <= hi
    return [ticks, fb.dump()]


FEEDBACK_CASES = [
    f_memory_bound_phase_grows_slice,
    f_compute_phase_shrinks_slice,
    f_phase_transition_tracks,
    f_unstable_contention_resets_window,
    f_contention_report_channel,
    f_bounds_respected,
    f_unstable_contention_resets_window_via_sim,
    f_shrink_clamps_overshoot_above_cap,
    f_adversarial_contention_never_escapes_band,
]


@pytest.mark.parametrize("case", FEEDBACK_CASES, ids=lambda c: c.__name__)
def test_feedback_case_twin(case, tmp_path):
    _twin(case, tmp_path)
