"""``pbst-torch`` — the port's command line.

    pbst-torch serve-demo   continuous-batching serving demo behind the
                            gateway front door, on the card by default
    pbst-torch serve        the sharded serving tier: 'demo' runs a
                            rule-partitioned backend (--disagg: the
                            prefill/decode pools) behind the gateway,
                            on the card by default; 'stats' prints the
                            partition table and its audit
    pbst-torch demo         the two-tenant sim demo end to end
    pbst-torch dump|top     one-shot counter dump / live telemetry from
                            a partition's ledger file (the 'z' key,
                            xentop)
    pbst-torch trace        format a drained trace ring (xentrace_format,
                            --chrome); 'trace spans OBS' rebuilds
                            request timelines
    pbst-torch slo          per-tenant SLO report from span artifacts
    pbst-torch mon          live scheduler history from a partition's
                            trace rings (xenmon)
    pbst-torch oprofile     passive sampling profile of another
                            process's ledger (xenoprof/opreport)
    pbst-torch perfc|lockprof|lockdep|params
                            format an obs dump (xenperf, xenlockprof,
                            the lock-order graph with --dump-graph, the
                            boot params; ``params`` alone reads this
                            process's registry)
    pbst-torch perf         hot-path microbench harness + regression
                            gate against the port's own baseline
    pbst-torch selftest     hot-path perf canary on every native tier
                            (x86_tests.c)
    pbst-torch ckpt-info    inspect a checkpoint directory
    pbst-torch quantize     int8 weight-only quantize a param checkpoint
    pbst-torch sched-credit adjust weight/cap/slice in a store db
                            (xl sched-credit)
    pbst-torch knobs        typed knob registry + atomic hot-reload
                            channel
    pbst-torch gateway      serving front door: demo over the sim
                            catalog (--federated, --processes), ledger
                            stats
    pbst-torch sim          trace-driven scheduler simulation
    pbst-torch tune         simulation-driven policy autotuning
    pbst-torch hw           the host hardware-counter plane: probe the
                            ladder, record/replay counter windows,
                            score sim-vs-real fidelity
    pbst-torch chaos        seeded chaos runs: the cluster control plane
                            (--plan chaos | rpc | none | FILE) or the
                            serving front door (--plan gateway |
                            federation | crash [--processes])
    pbst-torch journal      verify or dump a write-ahead gateway journal
    pbst-torch autopilot    the closed tuning loop: run --demo (shadow
                            capture, shadow search, SLO-guarded canary)
                            and the status/history views of its report
    pbst-torch scenarios    the scenario frontier: hunt, promote into
                            the corpus, replay it (--check), whatif
    pbst-torch create|destroy|pause|list|run|replicate|replicas|console|
               migrate     the xl-style surface of a live agent
                            (``--connect host:port``)
    pbst-torch store        ls/read/write/rm on a persisted store file
    pbst-torch check        the static invariant checkers over the port's
                            tree (.py and runtime/csrc/*.cc); exit 0
                            clean, 1 findings, 2 usage error

The port of ``pbs_tpu.cli.pbst``: the same flags (plus ``--device`` for
``serve-demo`` and ``serve``), the same output text and JSON shapes;
error lines start ``pbst-torch:``. ``check`` defaults to the path
``pbs_tpu_torch`` (the reference's to ``pbs_tpu`` and ``native``);
``perf`` gates against ``pbs_tpu_torch/perf/baseline.json``. The
``native`` stamp of ``sim`` and ``tune`` names the tier of the port's
native sim core (built at first use), or why it is off. ``scenarios promote`` writes into the
port's own corpus (``pbs_tpu_torch/scenarios/corpus/``) by default.
``serve stats`` builds its tree on the host and needs no card.

    python -m pbs_tpu_torch.cli.pbst serve-demo --device cpu
    python -m pbs_tpu_torch.cli.pbst serve demo --disagg --device cpu
    python -m pbs_tpu_torch.cli.pbst serve stats
    python -m pbs_tpu_torch.cli.pbst demo --ledger /tmp/p.ledger
    python -m pbs_tpu_torch.cli.pbst top --ledger /tmp/p.ledger
    python -m pbs_tpu_torch.cli.pbst oprofile --ledger /tmp/p.ledger
    python -m pbs_tpu_torch.cli.pbst perf --quick --check
    python -m pbs_tpu_torch.cli.pbst lockdep obs.json --dump-graph
    python -m pbs_tpu_torch.cli.pbst sim --workload mixed --policy all
    python -m pbs_tpu_torch.cli.pbst tune --check
    python -m pbs_tpu_torch.cli.pbst chaos --plan crash --selfcheck
    python -m pbs_tpu_torch.cli.pbst chaos --plan crash --processes
    python -m pbs_tpu_torch.cli.pbst list --connect 127.0.0.1:7001
    python -m pbs_tpu_torch.cli.pbst journal verify gateway.jrnl
    python -m pbs_tpu_torch.cli.pbst autopilot run --demo --pathological
    python -m pbs_tpu_torch.cli.pbst scenarios hunt --demo
    python -m pbs_tpu_torch.cli.pbst scenarios replay --check
    python -m pbs_tpu_torch.cli.pbst check --format json
    python -m pbs_tpu_torch.cli.pbst hw replay --check \
        pbs_tpu_torch/hwtelem/windows/w0.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_serve_demo(args) -> int:
    """Continuous-batching serving demo on a tiny model: submits a
    request mix THROUGH the gateway front door (admission + fair queue +
    routing), drains the engine, prints both surfaces — gateway stats
    and the engine's SLO stats (incl. prefix-cache hits). ``--device``
    defaults to the card and raises without one."""
    import numpy as np
    import torch

    from pbs_tpu_torch.gateway import BatcherBackend, Gateway, TenantQuota
    from pbs_tpu_torch.models import TransformerConfig, init_params
    from pbs_tpu_torch.models.serving import ContinuousBatcher
    from pbs_tpu_torch.models.transformer import resolve_device

    dev = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=128, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    eng = ContinuousBatcher(cfg, params, n_slots=args.slots,
                            prompt_bucket=16, max_len=64,
                            prefix_cache_size=args.prefix_cache, device=dev)
    gw = Gateway(
        [BatcherBackend("engine", eng)],
        quotas={"demo": TenantQuota(rate=1000.0, burst=256.0,
                                    slo="interactive",
                                    max_queued=max(64, args.requests))})
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 128, size=5)) for _ in range(3)]
    shed = 0
    for i in range(args.requests):
        r = gw.submit("demo", {"prompt": prompts[i % len(prompts)],
                               "max_new": 8})
        if not r.admitted:
            shed += 1
    done = []
    while gw.busy():
        done += gw.tick()
    print(json.dumps({
        "completions": len(done),
        "shed": shed,
        "sample_completion": done[0][1] if done else {},
        "gateway": gw.stats(),
        **eng.stats(),
    }, indent=1))
    return 0


def _serve_tiny_cfg():
    """The serve command's tiny model: small enough that construction
    plus a full demo stays inside the tier-1 smoke budget on the host,
    big enough that every partition rule family (embed / norms /
    attention / mlp / head) has a leaf to place."""
    import torch

    from pbs_tpu_torch.models import TransformerConfig

    return TransformerConfig(
        vocab=64, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1,
        d_ff=32, max_seq=64, dtype=torch.float32)


def cmd_serve(args) -> int:
    """The sharded serving tier, hands-on:

    - ``pbst-torch serve demo`` — a rule-partitioned 1x1-mesh backend
      (or, with ``--disagg``, the prefill/decode disaggregated pair)
      behind the REAL gateway front door; requests carry no prompt and
      the backend synthesizes deterministic ones from the rid (the
      chaos path). Prints one JSON object: completions + gateway stats
      + the serve backend's stats. ``--device`` defaults to the card
      and raises without one.
    - ``pbst-torch serve stats`` — the partition table's static story
      with no engine built: every template path with the rule that
      claims it and the resolved positional spec, plus the audit (dead
      / shadowed / uncovered — all must be empty; the serve-discipline
      pass gates the same facts). Its tree is drawn on the host.
    """
    import torch

    cfg = _serve_tiny_cfg()
    if args.action == "stats":
        import re

        from pbs_tpu_torch.models import init_params
        from pbs_tpu_torch.serve.partition import (
            PARTITION_RULES,
            audit_rules,
            iter_leaf_paths,
            match_partition_rules,
        )

        params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                             device="cpu")
        specs = match_partition_rules(PARTITION_RULES, params)
        spec_by_path = dict(iter_leaf_paths(specs))
        placed = {
            path: {"rule": next(pat for pat, _ in PARTITION_RULES
                                if re.search(pat, path)),
                   "spec": list(spec_by_path[path])}
            for path, _leaf in iter_leaf_paths(params)
        }
        print(json.dumps({
            "rules": [{"pattern": pat, "spec": list(spec)}
                      for pat, spec in PARTITION_RULES],
            "audit": audit_rules(PARTITION_RULES),
            "leaves": placed,
        }, indent=1))
        return 0

    from pbs_tpu_torch.gateway import Gateway, TenantQuota

    if args.disagg:
        from pbs_tpu_torch.serve import DisaggServeBackend

        backend = DisaggServeBackend(
            "serve0", cfg, n_slots=args.slots, prompt_bucket=8,
            max_len=32, seed=args.seed, device=args.device)
    else:
        from pbs_tpu_torch.serve import ShardedServeBackend

        backend = ShardedServeBackend(
            "serve0", cfg, n_slots=args.slots, prompt_bucket=8,
            max_len=32, seed=args.seed, device=args.device)
    hw_source = None
    if args.hw:
        from pbs_tpu_torch.hwtelem import HwCounterSource

        hw_source = HwCounterSource(probe=True)
    gw = Gateway(
        [backend],
        quotas={"demo": TenantQuota(rate=1000.0, burst=256.0,
                                    slo="interactive",
                                    max_queued=max(64, args.requests))},
        hw_source=hw_source)
    shed = 0
    for i in range(args.requests):
        # No prompt on purpose: the backend synthesizes one from the
        # rid, the same path chaos requests take.
        r = gw.submit("demo", {"req": i}, cost=1 + i % 4)
        if not r.admitted:
            shed += 1
    done = []
    while gw.busy():
        done += gw.tick()
    print(json.dumps({
        "completions": len(done),
        "shed": shed,
        "sample_completion": done[0][1] if done else {},
        "gateway": gw.stats(),
        "serve": backend.stats(),
    }, indent=1))
    return 0


def serve_entry() -> None:
    """Console entry ``pbst-torch-serve``: exactly ``pbst-torch serve
    ...`` without the subcommand word."""
    sys.exit(main(["serve", *sys.argv[1:]]))


def cmd_sim(args) -> int:
    """Trace-driven scheduler simulation (pbs_tpu_torch.sim): one policy
    run with metrics + trace digest, or --policy all for the comparison
    harness across every registered policy. Host-side virtual time
    only; ``--native`` requires the native sim core, ``--no-native``
    pins the Python witness engine."""
    from pbs_tpu_torch.sim import compare, format_report, run_policy
    from pbs_tpu_torch.sim.engine import policy_names
    from pbs_tpu_torch.sim.sweep import native_stamp
    from pbs_tpu_torch.sim.workload import workload_names

    horizon_ns = int(args.seconds * 1e9)
    if args.workload not in workload_names():
        print(f"pbst-torch: unknown workload {args.workload!r}; "
              f"available: {workload_names()}", file=sys.stderr)
        return 2
    if args.native is False:
        # Explicitly pinned to the witness engine: don't probe (or
        # try to build) the native library for a run that will never
        # touch it, and don't second-guess the user on stderr.
        stamp = {"native_tier": None, "native_requested": False}
    else:
        stamp = native_stamp()
        if not stamp["native_available"]:
            # Say WHY the native sim core is off — a silent slowdown
            # is a debugging session.
            reason = stamp.get("native_error", "unknown")
            if args.native:
                print(f"pbst-torch: --native requested but the native sim "
                      f"core is unavailable: {reason}", file=sys.stderr)
                return 2
            print(f"pbst-torch: note: native sim core unavailable ({reason});"
                  " pure-Python witness engine in use", file=sys.stderr)
    if args.policy == "all":
        # --trace becomes a per-policy prefix: <trace>.<policy>.jsonl.
        # --native stays a REQUIREMENT for the policies the C core
        # implements; compare() runs the rest (credit2/sedf/arinc653)
        # on the witness engine instead of refusing the whole table.
        try:
            cmp = compare(args.workload, seed=args.seed,
                          n_tenants=args.tenants,
                          n_executors=args.executors,
                          horizon_ns=horizon_ns, trace_prefix=args.trace,
                          native=args.native)
        except RuntimeError as e:
            print(f"pbst-torch: {e}", file=sys.stderr)
            return 2
        cmp["native"] = stamp
        if args.json:
            print(json.dumps(cmp, indent=1))
        else:
            print(format_report(cmp))
        return 0
    if args.policy not in policy_names():
        print(f"pbst-torch: unknown policy {args.policy!r}; "
              f"available: {policy_names()} or 'all'", file=sys.stderr)
        return 2
    try:
        report = run_policy(args.workload, args.policy, seed=args.seed,
                            n_tenants=args.tenants,
                            n_executors=args.executors,
                            horizon_ns=horizon_ns, trace_path=args.trace,
                            native=args.native)
    except RuntimeError as e:
        # Unsupported configuration under --native (non-hot policy,
        # multi-executor, ...): a usage error, not a stack trace.
        print(f"pbst-torch: {e}", file=sys.stderr)
        return 2
    if not args.json:
        # Default output is itself deterministic: the digest line is the
        # byte-identical witness two runs are compared on.
        print(f"workload={report['workload']} policy={report['policy']} "
              f"seed={report['seed']}")
        print(f"quanta={report['quanta']} switches={report['switches']} "
              f"jain={report['jain_fairness']} "
              f"p50_wait_us={report['wait_p50_us']} "
              f"p99_wait_us={report['wait_p99_us']}")
        for name, t in report["tenants"].items():
            print(f"  {name:<12} steps={t['steps']:>8} "
                  f"dev_ms={t['device_ns'] / 1e6:>9.1f} "
                  f"tslice_us={t['tslice_us']:>5} "
                  f"p99_wait_us={t['wait_p99_us']:>8}")
        print(f"trace_digest={report['trace_digest']} "
              f"native_tier={report['native_tier']}")
    else:
        print(json.dumps(report, indent=1))
    return 0


def cmd_tune(args) -> int:
    """Simulation-driven policy autotuning (pbs_tpu_torch.sched.tune).
    Default: run the successive-halving search for the selected
    workload(s) and print the frontier. ``--write`` emits the tuned
    profiles (checked in under pbs_tpu_torch/sched/tuned/). ``--check``
    replays every checked-in profile's deterministic score grid and
    exits 1 if any digest stopped reproducing."""
    from pbs_tpu_torch.sched import tune
    from pbs_tpu_torch.sim.sweep import native_stamp
    from pbs_tpu_torch.sim.workload import workload_names

    if args.check and args.write:
        print("pbst-torch: --check and --write are mutually exclusive: "
              "--check replays the RECORDED grids; after a drift, "
              "refresh with a separate `pbst-torch tune --write` run",
              file=sys.stderr)
        return 2
    if args.write and args.quick and args.tuned_dir is None:
        # A reduced search must not silently downgrade the checked-in
        # profiles (the check gate verifies reproducibility, not
        # search depth).
        print("pbst-torch: refusing to overwrite the checked-in tuned "
              "profiles from a --quick search (reduced space/rungs); "
              "drop --quick, or write elsewhere with --tuned-dir",
              file=sys.stderr)
        return 2
    if args.check:
        if args.quick or args.seed or args.policy != "feedback":
            # The check grid, its base seed and each profile's policy
            # are RECORDED in the profiles — say so instead of
            # silently accepting flags that change nothing.
            print("pbst-torch: note: --check replays each profile's recorded "
                  "grid/policy; --quick/--seed/--policy have no "
                  "effect on it", file=sys.stderr)
        names = (tune.tuned_workloads(args.tuned_dir)
                 if args.workload == "all" else [args.workload])
        if not names:
            print("pbst-torch: no tuned profiles found "
                  f"(dir: {args.tuned_dir or tune.TUNED_DIR})",
                  file=sys.stderr)
            return 2
        verdicts = []
        for wl in names:
            try:
                verdicts.append(tune.check_profile(
                    wl, args.tuned_dir, workers=args.workers))
            except (OSError, ValueError, KeyError) as e:
                print(f"pbst-torch: bad tuned profile {wl!r}: {e}",
                      file=sys.stderr)
                return 2
        ok = all(v["ok"] for v in verdicts)
        stamp = native_stamp()
        if args.json:
            print(json.dumps({"version": 1, "ok": ok,
                              "native": stamp,
                              "profiles": verdicts},
                             indent=1, sort_keys=True))
        else:
            for v in verdicts:
                status = "ok" if v["ok"] else "DIGEST MISMATCH"
                line = (f"{v['workload']:<10} {v['policy']:<9} "
                        f"score={v['got_score_x1e6'] / 1e6:+.6f} "
                        f"{status}")
                if v.get("recorded_tier") and \
                        v["recorded_tier"] != v["verified_tier"]:
                    # Tier-invariant digests: verifying a native-made
                    # block on the python witness (or vice versa) is
                    # the degradation contract working, not a skip.
                    line += (f" [recorded on {v['recorded_tier']}, "
                             f"verified on {v['verified_tier']}]")
                if not v["ok"]:
                    d = v["score_delta_x1e6"]
                    line += (f" (tuned score "
                             f"{'regressed' if d < 0 else 'moved'} "
                             f"{d / 1e6:+.6f}; refresh with "
                             f"`pbst-torch tune --write`)")
                print(line)
            tier = stamp.get("native_tier") or "python"
            print(f"{'ok' if ok else 'FAILED'} (sim tier: {tier})")
        return 0 if ok else 1

    if args.workload == "all":
        names = list(tune.TUNED_WORKLOADS)
    elif args.workload in workload_names():
        names = [args.workload]
    else:
        print(f"pbst-torch: unknown workload {args.workload!r}; "
              f"available: {workload_names()} or 'all'", file=sys.stderr)
        return 2
    if args.policy not in tune.SEARCH_SPACE:
        print(f"pbst-torch: no search space for policy {args.policy!r}; "
              f"tunable: {sorted(tune.SEARCH_SPACE)}", file=sys.stderr)
        return 2
    space = (tune.QUICK_SPACE if args.quick
             else tune.SEARCH_SPACE)[args.policy]
    rungs = tune.QUICK_RUNGS if args.quick else tune.RUNGS
    out = {}
    for wl in names:
        frontier = tune.successive_halving(
            wl, args.policy, configs=space, rungs=rungs,
            base_seed=args.seed, workers=args.workers)
        out[wl] = frontier
        if args.write:
            path = tune.write_profile(wl, frontier, base_seed=args.seed,
                                      tuned_dir=args.tuned_dir)
            print(f"wrote {path}", file=sys.stderr)
    stamp = native_stamp()
    if args.json:
        print(json.dumps({"version": 1, "native": stamp,
                          "workloads": out},
                         indent=1, sort_keys=True))
    else:
        print(f"{'workload':<10} {'policy':<9} {'score':>10} params")
        for wl, f in out.items():
            w = f["winner"]
            print(f"{wl:<10} {args.policy:<9} "
                  f"{w['score_x1e6'] / 1e6:>+10.6f} "
                  f"{json.dumps(w['params'], sort_keys=True)}")
        tier = stamp.get("native_tier") or "python"
        print(f"# sim tier: {tier}", file=sys.stderr)
    return 0


def cmd_hw(args) -> int:
    """The live hardware-counter plane (pbs_tpu_torch.hwtelem).

    - ``pbst-torch hw probe`` — walk the degradation ladder and print each
      tier with its cached ``unavailable_reason()`` and per-event
      degradation; exit 1 if NO tier works.
    - ``pbst-torch hw record --out F`` — drive the seeded gateway serving
      pump while sampling the live ladder; write the window JSONL.
    - ``pbst-torch hw replay W...`` — feed each recorded window through two
      fresh ``ReplaySource`` cursors; ``--check`` additionally demands
      the file bytes equal the canonical re-encoding and exits 1 on
      ANY drift (like ``pbst-torch tune --check``).
    - ``pbst-torch hw fidelity`` — sim-predicted vs window-measured per-axis
      report (``--window F`` scores a recorded window reproducibly;
      without it a live window is recorded first). ``--strict`` exits
      1 when the margin is negative.
    - ``pbst-torch hw report F`` — render a written fidelity report JSON.
    """
    from pbs_tpu_torch.hwtelem import (
        CounterWindow,
        ReplaySource,
        fidelity_report,
        probe_report,
        record_serving_window,
        render_report,
    )

    if args.action == "probe":
        rep = probe_report()
        if args.json:
            print(json.dumps(rep, indent=1, sort_keys=True))
        else:
            print(f"declared events: {', '.join(rep['declared_events'])}")
            for t in rep["tiers"]:
                mark = "*" if t["tier"] == rep["active"] else " "
                if t["available"]:
                    evs = ", ".join(t["events"]) or "-"
                    print(f" {mark}{t['tier']:<11} available  "
                          f"events: {evs}")
                    for ev, why in sorted((t.get("degraded")
                                           or {}).items()):
                        print(f"   {'':<11} {ev}: {why}")
                else:
                    print(f" {mark}{t['tier']:<11} UNAVAILABLE: "
                          f"{t['reason']}")
            print(f"active tier: {rep['active'] or 'none'}")
        return 0 if rep["active"] else 1

    if args.action == "record":
        window, rep = record_serving_window(
            seed=args.seed, ticks=args.ticks)
        window.save(args.out)
        out = {**rep, "out": args.out, "digest": window.digest(),
               "span_ns": window.span_ns()}
        if args.json:
            print(json.dumps(out, indent=1, sort_keys=True))
        else:
            print(f"recorded {out['samples']} samples "
                  f"(tier={out['tier']}, "
                  f"span={window.span_ns() / 1e6:.1f}ms) -> {args.out}")
            print(f"digest {out['digest']}")
        return 0

    if args.action == "replay":
        if not args.paths:
            print("pbst-torch: hw replay needs window file(s)",
                  file=sys.stderr)
            return 2
        failures = []
        for path in args.paths:
            try:
                w = CounterWindow.load(path)
            except (OSError, ValueError) as e:
                failures.append(f"{path}: unloadable: {e}")
                continue
            n = args.samples or max(1, 2 * len(w.samples))
            d1 = ReplaySource(w).stream_digest(n)
            d2 = ReplaySource(w).stream_digest(n)
            status = "ok"
            if d1 != d2:
                failures.append(f"{path}: replay digest drift "
                                f"{d1[:16]} != {d2[:16]}")
                status = "DRIFT"
            if args.check:
                with open(path, "rb") as f:
                    raw = f.read()
                canon = ("\n".join(w.lines()) + "\n").encode()
                if raw != canon:
                    failures.append(
                        f"{path}: file bytes are not the canonical "
                        f"encoding of their own window")
                    status = "DRIFT"
            print(f"{path}: window={w.digest()[:16]} "
                  f"stream={d1[:16]} x{n} [{status}]")
        for msg in failures:
            print(f"pbst-torch: {msg}", file=sys.stderr)
        return 1 if failures else 0

    if args.action == "fidelity":
        if args.window:
            w = CounterWindow.load(args.window)
        else:
            w, _rep = record_serving_window(seed=args.seed,
                                            ticks=args.ticks)
        rep = fidelity_report(w, seed=args.seed)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rep, f, indent=1, sort_keys=True)
                f.write("\n")
        if args.json:
            print(json.dumps(rep, indent=1, sort_keys=True))
        else:
            print(render_report(rep))
        return (0 if rep["ok"] else 1) if args.strict else 0

    if args.action == "report":
        if not args.paths:
            print("pbst-torch: hw report needs a fidelity JSON file",
                  file=sys.stderr)
            return 2
        try:
            with open(args.paths[0]) as f:
                rep = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"pbst-torch: bad report {args.paths[0]!r}: {e}",
                  file=sys.stderr)
            return 2
        print(render_report(rep))
        return 0

    print(f"pbst-torch: unknown hw action {args.action!r}", file=sys.stderr)
    return 2


def _print_federation_events(report: dict, problem_label: str) -> None:
    """Shared tail of the federation report renderers (chaos + demo):
    the membership timeline and any invariant problems."""
    for e in report["events"]:
        print(f"  t={e['tick_ns'] / 1e6:>8.1f}ms "
              f"{e['event']:<10} {e['gateway']}")
    for prob in report["problems"]:
        print(f"  {problem_label}: {prob}")


def cmd_chaos(args) -> int:
    """Seeded chaos run (``faults.chaos``): controller + agents over the
    sim workload catalog under an armed FaultPlan, end-state invariants
    checked, fault-trace digest printed (the determinism witness).
    ``--plan gateway`` attacks the serving front door instead
    (``gateway``: admission sheds/stalls, misroutes, a backend kill)
    with the "no admitted request lost" invariant.
    ``--plan federation`` attacks the front-door TIER
    (gateway/federation.py: gateway deaths, partitions, lease
    expiries, plus a seeded drain + rejoin schedule) with the
    no-job-lost AND no-rate-inflation invariants.
    ``--plan crash`` is the federation plan plus seeded kill-9s of
    the WHOLE process state, recovered from the write-ahead intent
    journal alone.
    ``--selfcheck`` runs the scenario twice and requires identical
    digests. ``--processes`` (federation/crash plans) runs members as
    REAL OS processes (``gateway.procfed``): ``--plan crash`` becomes
    literal SIGKILLs to member pids, each victim
    recovered from its journal bytes alone under supervision.
    Exit contract: 0 = every invariant held, 1 = an invariant (or the
    selfcheck digest match) failed, 2 = usage error."""
    from pbs_tpu_torch.faults import FaultPlan, run_chaos

    if args.processes and args.plan not in ("federation", "crash"):
        print("pbst-torch: --processes applies to --plan federation/crash",
              file=sys.stderr)
        return 2
    if args.processes:
        from pbs_tpu_torch.gateway import run_federation_chaos
        from pbs_tpu_torch.gateway.procfed import stock_process_kill_plan

        if args.selfcheck and args.plan == "crash":
            # The restart timeline is a host-scheduler fact; only the
            # DISARMED process run carries a full digest.
            print("pbst-torch: --selfcheck with --processes needs "
                  "--plan federation (armed runs are wall-clock "
                  "nondeterministic)", file=sys.stderr)
            return 2
        ticks = args.rounds * 80
        kw = dict(workload=args.workload, seed=args.seed,
                  n_gateways=args.gateways, n_tenants=args.tenants,
                  ticks=ticks, process_mode=True)
        if args.plan == "crash":
            # Tick-positioned kills only: a real SIGKILL cannot be
            # aimed at a byte offset (record cuts stay in-process).
            kw["crash_plan"] = stock_process_kill_plan(ticks)
        report = run_federation_chaos(**kw)
        ok = report["ok"]
        if args.selfcheck:
            again = run_federation_chaos(**kw)
            match = again["digest"] == report["digest"]
            report["selfcheck"] = {
                "digest_match": match, "second_ok": again["ok"],
                "second_digest": again["digest"],
            }
            ok = ok and match and again["ok"]
        if args.json:
            print(json.dumps(report, indent=1, sort_keys=True))
        else:
            st = report["stats"]
            proc = report["process"]
            label = ("process crash chaos" if args.plan == "crash"
                     else "process federation chaos")
            print(f"{label} workload={report['workload']} "
                  f"seed={report['seed']} gateways={report['gateways']} "
                  f"ticks={report['ticks']}")
            print(f"admitted={st['admitted']} "
                  f"completed={st['completed']} "
                  f"handoffs={st['handoffs']} "
                  f"torn_acks={proc['torn_acks']} shed={st['shed']}")
            for name, m in proc["members"].items():
                print(f"  {name:<8} pid={m['pid']:>7} "
                      f"state={m['state']:<10} "
                      f"restarts={m['restarts']} "
                      f"recovered_from_journal="
                      f"{m['recovered_from_journal']}")
            for k in proc["kills"]:
                print(f"  SIGKILL {k['member']} pid={k['pid']} "
                      f"@ tick {k['tick']}")
            for r in proc["recoveries"]:
                print(f"  recovered {r['member']} -> gen "
                      f"{r['generation']} (recovered {r['recovered']},"
                      f" requeued {r['requeued_inflight']}, torn "
                      f"{r['torn_bytes']} B)")
            for prob in report["problems"]:
                print(f"  INVARIANT VIOLATED: {prob}")
            if args.selfcheck:
                sc = report["selfcheck"]
                print(f"selfcheck: digest_match={sc['digest_match']} "
                      f"second_ok={sc['second_ok']}")
            print(f"arrivals_digest={report['arrivals_digest']}")
            if "digest" in report:
                print(f"digest={report['digest']}")
            print("ok" if ok else "FAILED")
        return 0 if ok else 1

    if args.plan in ("federation", "crash"):
        from pbs_tpu_torch.gateway import run_federation_chaos, stock_crash_plan

        ticks = args.rounds * 80
        kw = dict(workload=args.workload, seed=args.seed,
                  n_gateways=args.gateways, n_tenants=args.tenants,
                  ticks=ticks, trace_path=args.trace,
                  obs_dir=args.obs)
        if args.plan == "crash":
            # The kill-9 plan (docs/DURABILITY.md): the federation
            # plan PLUS seeded whole-process deaths — one torn
            # mid-frame journal commit, one tick-boundary kill —
            # recovered from journal bytes alone.
            kw["crash_plan"] = stock_crash_plan(ticks)
        report = run_federation_chaos(**kw)
        ok = report["ok"]
        if args.selfcheck:
            again = run_federation_chaos(**kw)
            match = (again["trace_digest"] == report["trace_digest"]
                     and again["report_digest"] == report["report_digest"])
            report["selfcheck"] = {
                "digest_match": match, "second_ok": again["ok"],
                "second_digest": again["trace_digest"],
            }
            ok = ok and match and again["ok"]
        if args.json:
            print(json.dumps(report, indent=1, sort_keys=True))
        else:
            st = report["stats"]
            label = ("crash chaos" if args.plan == "crash"
                     else "federation chaos")
            print(f"{label} workload={report['workload']} "
                  f"seed={report['seed']} gateways={report['gateways']} "
                  f"ticks={report['ticks']}")
            if "crash" in report:
                c = report["crash"]
                print(f"recoveries={c['recoveries']} "
                      f"unacked={c['unacked']} "
                      f"final_generation={c['final_generation']}")
                for e in c["events"]:
                    print(f"  kill {e['kind']} @ {e['position']} -> "
                          f"gen {e['generation']} "
                          f"(recovered {e['recovered']}, requeued "
                          f"{e['requeued_inflight']}, torn "
                          f"{e['torn_bytes']} B, unacked "
                          f"{e['unacked']})")
            print(f"admitted={st['admitted']} completed={st['completed']} "
                  f"handoffs={st['handoffs']} remaps={st['remaps']} "
                  f"lease_refusals={st['lease_refusals']} "
                  f"faults_fired={sum(report['faults_fired'].values())}")
            for k, v in report["faults_fired"].items():
                print(f"  {k:<32} {v}")
            _print_federation_events(report, "INVARIANT VIOLATED")
            if args.selfcheck:
                sc = report["selfcheck"]
                print(f"selfcheck: digest_match={sc['digest_match']} "
                      f"second_ok={sc['second_ok']}")
            print(f"trace_digest={report['trace_digest']}")
            print(f"report_digest={report['report_digest']}")
            print("ok" if ok else "FAILED")
        return 0 if ok else 1

    if args.plan == "gateway":
        from pbs_tpu_torch.gateway import run_gateway_chaos

        kw = dict(workload=args.workload, seed=args.seed,
                  n_backends=args.agents, n_tenants=args.tenants,
                  ticks=args.rounds * 80, trace_path=args.trace,
                  obs_dir=args.obs)
        report = run_gateway_chaos(**kw)
        ok = report["ok"]
        if args.selfcheck:
            again = run_gateway_chaos(**kw)
            match = again["trace_digest"] == report["trace_digest"]
            report["selfcheck"] = {
                "digest_match": match, "second_ok": again["ok"],
                "second_digest": again["trace_digest"],
            }
            ok = ok and match and again["ok"]
        if args.json:
            print(json.dumps(report, indent=1, sort_keys=True))
        else:
            st = report["stats"]
            print(f"gateway chaos workload={report['workload']} "
                  f"seed={report['seed']} backends={report['backends']} "
                  f"ticks={report['ticks']} "
                  f"killed={report['killed_backend']}")
            print(f"admitted={st['admitted']} completed={st['completed']} "
                  f"requeued={st['requeued']} "
                  f"shed_rate={st['shed_rate']} "
                  f"faults_fired={sum(report['faults_fired'].values())}")
            for k, v in report["faults_fired"].items():
                print(f"  {k:<32} {v}")
            for prob in report["problems"]:
                print(f"  INVARIANT VIOLATED: {prob}")
            if args.selfcheck:
                sc = report["selfcheck"]
                print(f"selfcheck: digest_match={sc['digest_match']} "
                      f"second_ok={sc['second_ok']}")
            print(f"trace_digest={report['trace_digest']}")
            print("ok" if ok else "FAILED")
        return 0 if ok else 1

    if args.plan == "chaos":
        plan = FaultPlan.chaos(args.seed)
    elif args.plan == "rpc":
        plan = FaultPlan.rpc_chaos(args.seed)
    elif args.plan == "none":
        plan = FaultPlan(seed=args.seed)  # dry run: seams armed, no rules
    else:
        try:
            with open(args.plan) as f:
                plan = FaultPlan.from_dict(json.load(f))
        except (OSError, ValueError, KeyError) as e:
            print(f"pbst-torch: bad fault plan {args.plan!r}: {e}",
                  file=sys.stderr)
            return 2

    kw = dict(workload=args.workload, seed=args.seed,
              n_agents=args.agents, n_tenants=args.tenants,
              rounds=args.rounds, plan=plan, trace_path=args.trace,
              replicate=not args.no_replication)
    report = run_chaos(**kw)
    ok = report["ok"]
    if args.selfcheck:
        again = run_chaos(**kw)
        match = again["trace_digest"] == report["trace_digest"]
        report["selfcheck"] = {
            "digest_match": match, "second_ok": again["ok"],
            "second_digest": again["trace_digest"],
        }
        ok = ok and match and again["ok"]
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(f"workload={report['workload']} seed={report['seed']} "
              f"agents={report['agents']} rounds={report['rounds']}")
        print(f"faults_fired={sum(report['faults_fired'].values())} "
              f"retries={report['client_retries']} "
              f"idem_hits={report['idem_hits']} "
              f"round_errors={report['round_errors']}")
        for k, v in report["faults_fired"].items():
            print(f"  {k:<32} {v}")
        for prob in report["problems"]:
            print(f"  INVARIANT VIOLATED: {prob}")
        if args.selfcheck:
            sc = report["selfcheck"]
            print(f"selfcheck: digest_match={sc['digest_match']} "
                  f"second_ok={sc['second_ok']}")
        print(f"trace_digest={report['trace_digest']}")
        print("ok" if ok else "FAILED")
    return 0 if ok else 1


def _parse_addr(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return (host or "127.0.0.1", int(port))


def _agent_client(args):
    from pbs_tpu_torch.dist.rpc import RpcClient

    # deadline_s bounds the whole retry loop: a dead agent fails the
    # command in bounded time instead of hanging the terminal.
    return RpcClient(_parse_addr(args.connect), deadline_s=60.0)


def cmd_create(args) -> int:
    """xl create analog: create a job on a live agent."""
    cli = _agent_client(args)
    spec = json.loads(args.spec) if args.spec else {}
    if args.weight is not None:
        spec.setdefault("sched", {})["weight"] = args.weight
    if args.max_steps is not None:
        spec["max_steps"] = args.max_steps
    r = cli.call("create_job", job=args.job, workload=args.workload,
                 spec=spec, subject=args.subject)
    print(json.dumps(r))
    cli.close()
    return 0


def cmd_destroy(args) -> int:
    cli = _agent_client(args)
    cli.call("remove_job", job=args.job, subject=args.subject)
    cli.close()
    return 0


def cmd_pause(args) -> int:
    cli = _agent_client(args)
    op = "unpause_job" if args.unpause else "pause_job"
    cli.call(op, job=args.job, subject=args.subject)
    cli.close()
    return 0


def cmd_list(args) -> int:
    """xl list analog."""
    cli = _agent_client(args)
    info = cli.call("info")
    rows = cli.call("list_jobs")
    print(f"agent={info['agent']} partition={info['partition']} "
          f"scheduler={info['scheduler']}")
    print(f"{'job':<16} {'state':<10} {'steps':>10} {'weight':>7} "
          f"{'tslice':>7}")
    for r in rows:
        print(f"{r['job']:<16} {r.get('state', '?'):<10} "
              f"{r.get('steps', 0):>10} {r.get('weight', ''):>7} "
              f"{r.get('tslice_us', ''):>7}")
    cli.close()
    return 0


def cmd_replicate(args) -> int:
    """Remus surface: start/stop/status of a job's replication pump on
    its source agent (tools/remus CLI analog)."""
    cli = _agent_client(args)
    try:
        if args.action == "start":
            if not args.peer:
                print("pbst-torch: replicate start needs --peer host:port",
                      file=sys.stderr)
                return 1
            try:
                host, port = _parse_addr(args.peer)
            except ValueError:
                print(f"pbst-torch: bad --peer {args.peer!r} "
                      "(expected host:port)", file=sys.stderr)
                return 1
            st = cli.call("replicate_start", job=args.job, peer_host=host,
                          peer_port=port, period_s=args.period,
                          subject=args.subject)
            print(json.dumps(st))
        elif args.action == "stop":
            ok = cli.call("replicate_stop", job=args.job,
                          subject=args.subject)
            print(json.dumps({"stopped": ok}))
        else:  # status
            st = cli.call("replicate_status", job=args.job,
                          subject=args.subject)
            print(json.dumps(st, indent=1))
    finally:
        cli.close()
    return 0


def cmd_replicas(args) -> int:
    """What replicas a backup host holds (the failover inventory)."""
    cli = _agent_client(args)
    try:
        rows = cli.call("list_replicas", subject=args.subject)
        print(f"{'job':<16} {'epoch':>8} {'source':<12} {'age_s':>8}")
        for r in rows:
            print(f"{r['job']:<16} {r['epoch']:>8} {r['source']:<12} "
                  f"{r['age_s']:>8.2f}")
    finally:
        cli.close()
    return 0


def cmd_console(args) -> int:
    """xl console analog: stream a job's console ring from an agent."""
    import time as _t

    cli = _agent_client(args)
    since = args.since
    try:
        while True:
            r = cli.call("console", job=args.job, since=since,
                         subject=args.subject)
            if r.get("dropped"):
                print(f"[... {r['dropped']} line(s) lost to the ring ...]")
            for ln in r["lines"]:
                print(f"[{ln['seq']:>6}] {ln['line']}")
            since = r["next"]
            if not args.follow:
                break
            _t.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        cli.close()
    return 0


def cmd_run(args) -> int:
    """Drive scheduler rounds on a live agent."""
    cli = _agent_client(args)
    quanta = cli.call("run", _timeout=600.0, max_rounds=args.rounds)
    print(json.dumps({"quanta": quanta}))
    cli.close()
    return 0


def cmd_migrate(args) -> int:
    """xl migrate analog: save on source, restore on dest, teardown.
    Workload/spec default to the save record's provenance; --spec only
    overrides deliberately."""
    from pbs_tpu_torch.dist.rpc import RpcClient

    src = RpcClient(_parse_addr(args.connect), deadline_s=60.0)
    dst = RpcClient(_parse_addr(args.to), deadline_s=60.0)
    try:
        saved = src.call("save_job", job=args.job, subject=args.subject)
        try:
            r = dst.call("restore_job", job=args.job,
                         workload=args.workload,
                         spec=json.loads(args.spec) if args.spec else None,
                         saved=saved, subject=args.subject)
        except Exception:
            src.call("unpause_job", job=args.job, subject=args.subject)
            raise
        src.call("remove_job", job=args.job, subject=args.subject)
        print(json.dumps(r))
    finally:
        src.close()
        dst.close()
    return 0


def cmd_store(args) -> int:
    from pbs_tpu_torch.store import Store

    s = Store(persist_path=args.db)
    subj = args.subject
    if args.op == "ls":
        for name in s.ls(args.path, subject=subj):
            print(name)
    elif args.op == "read":
        v = s.read(args.path, subject=subj)
        if v is None and not s.exists(args.path, subject=subj):
            print(f"pbst-torch: no entry {args.path}", file=sys.stderr)
            return 1
        print(json.dumps(v))
    elif args.op == "write":
        if args.value is None:
            print("pbst-torch: store write requires a JSON value", file=sys.stderr)
            return 2
        s.write(args.path, json.loads(args.value), subject=subj)
    elif args.op == "rm":
        print(s.rm(args.path, subject=subj))
    return 0


def cmd_journal(args) -> int:
    """Inspect a write-ahead gateway journal (docs/DURABILITY.md); the
    reference's ``pbst journal``, byte for byte the same JSON.

    ``dump``   — every sealed record as stable sorted-key JSON
                 (intern table applied, float odometers unpacked).
    ``verify`` — validate frames/CRCs and summarize.

    Exit-code contract (both actions): 0 = valid, possibly with a
    torn-tail WARNING (a crash artifact — expected, never trusted);
    2 = corrupt body (CRC/marker mismatch on a complete frame) or not
    a journal at all. A torn tail never exits nonzero: recovery
    handles it by design, and CI must distinguish 'crashed while
    writing' from 'bits rotted'."""
    from pbs_tpu_torch.gateway.journal import (
        JournalCorrupt,
        format_record,
        iter_interned,
        read_journal,
    )

    try:
        view = read_journal(args.path)
    except JournalCorrupt as e:
        print(f"pbst-torch journal: CORRUPT: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"pbst-torch journal: cannot read {args.path!r}: {e}",
              file=sys.stderr)
        return 2
    names = {sid: name for name, sid in iter_interned(view.records)}
    warnings = []
    if view.torn_bytes:
        warnings.append(
            f"torn tail: {view.torn_bytes} trailing byte(s) past the "
            f"last sealed frame (crash artifact; never replayed)")
    doc = {
        "path": args.path,
        "generation": view.generation,
        "frames": view.frames,
        "records": len(view.records),
        "valid_bytes": view.valid_bytes,
        "torn_bytes": view.torn_bytes,
        "warnings": warnings,
    }
    if args.action == "dump":
        doc["entries"] = [format_record(r, names)
                          for r in view.records]
    print(json.dumps(doc, indent=1, sort_keys=True))
    if warnings and not args.json_only:
        for w in warnings:
            print(f"pbst-torch journal: WARNING: {w}", file=sys.stderr)
    return 0


def _autopilot_history_lines(history: list) -> list[str]:
    out = []
    for e in history:
        t_ms = e.get("t_ns", 0) / 1e6
        line = f"  t={t_ms:>8.1f}ms {e['event']:<9}"
        if e["event"] == "propose":
            line += (f" workload={e.get('workload')} "
                     f"margin_x1e6={e.get('margin_x1e6')}"
                     + (" INJECTED" if e.get("injected") else ""))
        elif e["event"] == "canary":
            line += f" members={','.join(e.get('members', []))}"
        elif e["event"] in ("promote", "rollback"):
            burns = e.get("burns") or {}
            worst = max(burns.values(), default=0.0)
            line += f" members={','.join(e.get('members', []))}"
            if e["event"] == "rollback":
                line += f" reason={e.get('reason')}"
            line += f" worst_burn={worst}"
        elif e["event"] == "hold":
            if "reason" in e:
                line += f" reason={e['reason']}"
            if e.get("margin_x1e6") is not None:
                line += f" margin_x1e6={e['margin_x1e6']}"
        out.append(line)
    return out


def cmd_autopilot(args) -> int:
    """Shadow-replay self-tuning loop (docs/AUTOPILOT.md).

    ``run --demo`` drives one seeded end-to-end loop on a virtual
    clock (3-member federation, catalog arrivals, quick shadow search,
    canary, promote/rollback) and prints — or writes with ``--out`` —
    the decision report; ``--pathological`` injects the adversarially
    bad candidate and therefore demonstrates the guarded rollback.
    ``status``/``history`` render a written report. Exit 0 = loop ran
    to completion and the federation drained."""
    if args.action == "run":
        if not args.demo:
            print("pbst-torch: only `autopilot run --demo` is wired to a "
                  "self-contained loop; a live deployment embeds "
                  "pbs_tpu_torch.autopilot.Autopilot in its own pump "
                  "(docs/AUTOPILOT.md)", file=sys.stderr)
            return 2
        from pbs_tpu_torch.autopilot import run_autopilot_demo

        report = run_autopilot_demo(seed=args.seed, ticks=args.ticks,
                                    pathological=args.pathological)
        if args.fidelity or args.fidelity_window:
            # The sim-vs-real leg (docs/HWTELEM.md): additive key —
            # runs without --fidelity carry no trace of it, so the
            # demo report shape (and anything pinned on it) is
            # untouched.
            from pbs_tpu_torch.hwtelem import (
                CounterWindow,
                fidelity_report,
                record_serving_window,
                render_report,
            )

            if args.fidelity_window:
                fw = CounterWindow.load(args.fidelity_window)
            else:
                fw, _frep = record_serving_window(seed=args.seed)
            report["fidelity"] = fidelity_report(fw, seed=args.seed)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1, sort_keys=True)
                f.write("\n")
        if args.json:
            print(json.dumps(report, indent=1, sort_keys=True))
        else:
            st = report["status"]
            print(f"autopilot demo seed={report['seed']} "
                  f"ticks={report['ticks']} "
                  f"pathological={report['pathological']}")
            print(f"state={st['state']} rounds={st['rounds']} "
                  f"recorded={st['recorded_arrivals']} "
                  f"adoptions={st['adoptions']}")
            for line in _autopilot_history_lines(report["history"]):
                print(line)
            s = report["stats"]
            print(f"admitted={s['admitted']} "
                  f"completed={s['completed']} "
                  f"drained={s['drained']}")
            if "fidelity" in report:
                print(render_report(report["fidelity"]))
        ok = report["stats"]["drained"] and \
            report["status"]["state"] == "done"
        return 0 if ok else 1

    # status / history read a written report artifact.
    if not args.state:
        print("pbst-torch: autopilot status/history need --state FILE "
              "(written by `autopilot run --demo --out FILE`)",
              file=sys.stderr)
        return 2
    try:
        with open(args.state) as f:
            report = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"pbst-torch: bad --state {args.state!r}: {e}", file=sys.stderr)
        return 2
    if args.action == "status":
        if args.json:
            print(json.dumps(report.get("status", {}), indent=1,
                             sort_keys=True))
        else:
            st = report.get("status", {})
            print(f"state={st.get('state')} rounds={st.get('rounds')} "
                  f"decisions={','.join(st.get('decisions', []))}")
            print(f"recorded={st.get('recorded_arrivals')} "
                  f"dropped={st.get('dropped_arrivals')} "
                  f"adoptions={st.get('adoptions')}")
            for k, v in sorted(st.get("reference", {}).items()):
                print(f"  reference {k}={v}")
        return 0
    if args.action == "history":
        history = report.get("history", [])
        if args.json:
            print(json.dumps(history, indent=1, sort_keys=True))
        else:
            for line in _autopilot_history_lines(history):
                print(line)
            print(f"{len(history)} decision event(s)")
        return 0
    print(f"pbst-torch: unknown autopilot action {args.action!r}",
          file=sys.stderr)
    return 2


def cmd_scenarios(args) -> int:
    """Coverage-guided adversarial scenario frontier
    (pbs_tpu_torch.scenarios; docs/SCENARIOS.md).

    ``hunt`` runs the MAP-Elites search (``--demo``: the tier-1 smoke
    shape, ≤5 s) and prints — or writes with ``--out`` — the archive
    document. ``promote`` graduates a hunt archive's per-axis best
    entries into corpus files (default: the checked-in
    pbs_tpu_torch/scenarios/corpus/). ``replay`` re-runs the corpus through
    the chaos invariant gate; ``--check`` additionally demands
    byte-identical golden digests — the CI regression mode, exit 1 on
    any drift (exactly like `pbst-torch tune --check`)."""
    from pbs_tpu_torch import scenarios

    if args.action == "hunt":
        if args.knobs:
            # A fresh process only sees registry defaults; adopt the
            # channel file's values into the process overlay so
            # a channel push of scenarios.hunt.population=32
            # actually reshapes THIS hunt (HuntConfig.from_knobs and
            # the scoring-weight snapshot both read through it).
            from pbs_tpu_torch import knobs as registry
            from pbs_tpu_torch.knobs.channel import KnobChannel

            try:
                _, vals = KnobChannel.attach(args.knobs).snapshot()
                registry.set_local(vals)
            except (OSError, ValueError) as e:
                print(f"pbst-torch: bad --knobs {args.knobs!r}: {e}",
                      file=sys.stderr)
                return 2
        cfg = (scenarios.HuntConfig.demo(seed=args.seed) if args.demo
               else scenarios.HuntConfig.from_knobs(seed=args.seed))
        progress = (None if args.json
                    else lambda line: print(line, file=sys.stderr))
        result = scenarios.hunt(cfg, workers=args.workers,
                                progress=progress)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"wrote {args.out}", file=sys.stderr)
        if args.json:
            print(json.dumps(result, indent=1, sort_keys=True))
        else:
            print(f"{'signature':<12} {'score':>9} "
                  f"{' '.join(f'{a:>9}' for a in scenarios.AXES)}")
            for sig in sorted(
                    result["archive"],
                    key=lambda s: (-result["archive"][s]["score"], s)):
                e = result["archive"][sig]
                print(f"{sig:<12} {e['score']:>9.4f} "
                      + " ".join(f"{e['axes'][a]:>9.4f}"
                                 for a in scenarios.AXES))
            print(f"archive {len(result['archive'])} entr(ies), "
                  f"{len(result['rejected'])} gate-rejected, "
                  f"digest {result['archive_digest'][:16]}…")
        return 0

    if args.action == "promote":
        if not args.archive:
            print("pbst-torch: promote needs --archive FILE (written by "
                  "`scenarios hunt --out FILE`)", file=sys.stderr)
            return 2
        try:
            with open(args.archive) as f:
                hunt_result = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"pbst-torch: bad --archive {args.archive!r}: {e}",
                  file=sys.stderr)
            return 2
        axes = (tuple(a.strip() for a in args.axes.split(",")
                      if a.strip())
                if args.axes else scenarios.PROMOTE_AXES)
        if not axes:
            print(f"pbst-torch: --axes {args.axes!r} names no stress axes",
                  file=sys.stderr)
            return 2
        try:
            outcomes = scenarios.promote_frontier(
                hunt_result, corpus_dir=args.corpus, axes=axes)
        except (KeyError, ValueError) as e:
            print(f"pbst-torch: promote failed: {e}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps({"version": 1, "outcomes": outcomes},
                             indent=1, sort_keys=True))
        else:
            for o in outcomes:
                if o["promoted"]:
                    print(f"{o['axis']:<9} promoted {o['name']} "
                          f"(axis {o['axis_value']:.4f}, score "
                          f"{o['score']:.4f}) -> {o['path']}")
                else:
                    print(f"{o['axis']:<9} SKIPPED: {o['reason']}")
        return 0 if all(o["promoted"] for o in outcomes) else 1

    if args.action == "replay":
        try:
            result = scenarios.replay_corpus(corpus_dir=args.corpus,
                                             check=args.check)
        except (OSError, ValueError) as e:
            print(f"pbst-torch: bad corpus: {e}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(result, indent=1, sort_keys=True))
        else:
            for v in result["verdicts"]:
                status = "ok" if v["ok"] else "FAILED"
                line = f"{v['name']:<22} {v['axis'] or '-':<9} {status}"
                if not v["ok"]:
                    line += f" ({'; '.join(v['problems'][:2])})"
                print(line)
            print(f"{'ok' if result['ok'] else 'FAILED'} "
                  f"({result['entries']} scenario(s), corpus digest "
                  f"{result['corpus_digest'][:16]}…"
                  f"{', digests checked' if args.check else ''})")
        if not result["verdicts"]:
            print("pbst-torch: corpus is empty "
                  f"(dir: {result['corpus_dir']})", file=sys.stderr)
            return 2
        return 0 if result["ok"] else 1

    if args.action == "whatif":
        paths = scenarios.corpus_paths(args.corpus)
        if not paths:
            print("pbst-torch: corpus is empty "
                  f"(dir: {args.corpus or scenarios.CORPUS_DIR})",
                  file=sys.stderr)
            return 2
        out = []
        for p in paths:
            try:
                out.append(scenarios.whatif_entry(
                    scenarios.load_entry(p), workers=args.workers))
            except (OSError, ValueError) as e:
                print(f"pbst-torch: bad corpus entry {p!r}: {e}",
                      file=sys.stderr)
                return 2
        if args.json:
            print(json.dumps({"version": 1, "whatif": out},
                             indent=1, sort_keys=True))
        else:
            for w in out:
                pr = w["proposal"]
                print(f"{w['name']:<22} class={w['workload_class']:<9} "
                      f"arrivals={w['arrivals']:<5} "
                      f"margin={pr['margin_x1e6'] / 1e6:+.6f} "
                      f"candidate={json.dumps(pr['candidate'], sort_keys=True)}")
        return 0

    print(f"pbst-torch: unknown scenarios action {args.action!r}",
          file=sys.stderr)
    return 2


def _load_meta(ledger_path: str) -> dict:
    try:
        with open(ledger_path + ".meta.json") as f:
            return json.load(f)
    except FileNotFoundError:
        return {"partition": "?", "scheduler": "?", "slots": {}}


def _ledger(args):
    from pbs_tpu_torch.telemetry import Ledger

    if not os.path.exists(args.ledger):
        raise SystemExit(f"pbst-torch: no ledger at {args.ledger}")
    # Monitors attach read-only; slot count comes from the file itself
    # so a mismatched --slots can neither truncate nor over-index the
    # producer's live mapping.
    return Ledger.file_backed(args.ledger, readonly=True)


def _fmt_row(slot, info, snap, prev=None, dt=1.0):
    from pbs_tpu_torch.telemetry import Counter

    steps = int(snap[Counter.STEPS_RETIRED])
    dev_ms = int(snap[Counter.DEVICE_TIME_NS]) / 1e6
    stall = int(snap[Counter.HBM_STALL_NS])
    dev = int(snap[Counter.DEVICE_TIME_NS])
    stall_pct = 100.0 * stall / dev if dev else 0.0
    rate = ""
    if prev is not None:
        dsteps = steps - int(prev[Counter.STEPS_RETIRED])
        rate = f"{dsteps / dt:8.1f}"
    return (
        f"{slot:>4} {info.get('ctx', '?'):<16} {info.get('weight', ''):>6} "
        f"{info.get('cap', ''):>4} {info.get('tslice_us', ''):>8} "
        f"{steps:>10} {dev_ms:>10.1f} {stall_pct:>6.1f} {rate:>8}"
    )


HDR = (
    f"{'slot':>4} {'ctx':<16} {'weight':>6} {'cap':>4} {'tslice':>8} "
    f"{'steps':>10} {'dev_ms':>10} {'stall%':>6} {'st/s':>8}"
)


def _fmt_source(meta: dict) -> str:
    """Counter-source provenance line: which ladder tier feeds these
    numbers — and WHY the better tiers aren't — so sim-sourced numbers
    are never passed off as live. Empty for sidecars without a source
    stamp."""
    src = meta.get("source")
    if not isinstance(src, dict):
        return ""
    tier = src.get("tier", "?")
    if tier is None or src.get("available") is False:
        reason = src.get("reason") or "unavailable"
        return f"counters=none (UNAVAILABLE: {reason})"
    degraded = src.get("degraded") or {}
    if degraded:
        why = "; ".join(f"{ev}: {r}" for ev, r in sorted(degraded.items()))
        return f"counters={tier} (degraded — {why})"
    return f"counters={tier}"


def cmd_dump(args) -> int:
    """One-shot counter dump of a partition's ledger file (the 'z'
    console key, csched_dump_customized sched_credit.c:1944-1977)."""
    led = _ledger(args)
    meta = _load_meta(args.ledger)
    print(f"partition={meta['partition']} scheduler={meta['scheduler']}")
    src_line = _fmt_source(meta)
    if src_line:
        print(src_line)
    print(HDR)
    rows = sorted(meta["slots"].items(), key=lambda kv: int(kv[0]))
    snaps = led.snapshot_many([int(s) for s, _ in rows])
    for (slot_s, info), snap in zip(rows, snaps):
        print(_fmt_row(int(slot_s), info, snap))
    return 0


def cmd_top(args) -> int:
    """Live per-job telemetry from a shared ledger file (xentop):
    lock-free snapshots, the meta sidecar reloaded every iteration."""
    import time

    led = _ledger(args)
    prev: dict = {}
    try:
        for _ in range(args.iterations if args.iterations > 0 else 10**9):
            meta = _load_meta(args.ledger)
            slot_rows = sorted(meta["slots"].items(),
                               key=lambda kv: int(kv[0]))
            snaps = led.snapshot_many([int(s) for s, _ in slot_rows])
            rows = []
            for (slot_s, info), snap in zip(slot_rows, snaps):
                slot = int(slot_s)
                rows.append(_fmt_row(slot, info, snap, prev.get(slot),
                                     args.interval))
                prev[slot] = snap
            sys.stdout.write("\x1b[2J\x1b[H" if args.clear else "")
            print(f"pbst top — partition={meta['partition']} "
                  f"scheduler={meta['scheduler']} "
                  f"({time.strftime('%H:%M:%S')})")
            src_line = _fmt_source(meta)
            if src_line:
                print(src_line)
            print(HDR)
            print("\n".join(rows))
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_trace(args) -> int:
    """Format a drained trace ring (xentrace_format), or export it as
    Chrome trace-event JSON; ``trace spans OBS`` rebuilds request
    timelines from span artifacts."""
    import numpy as np

    from pbs_tpu_torch.obs.trace import format_records

    if args.file == "spans":
        return _cmd_trace_spans(args)
    recs = np.load(args.file)
    if getattr(args, "chrome", None):
        with open(args.chrome, "w") as f:
            json.dump(_chrome_with_phases(args.file, recs), f)
        print(f"wrote {len(recs)} records to {args.chrome} "
              "(chrome://tracing / Perfetto)")
        return 0
    for line in format_records(recs):
        print(line)
    return 0


def _chrome_with_phases(path: str, recs) -> dict:
    """Chrome JSON of a saved stream: phase records (the port's class
    0x0Axx, names from the sidecar ``PhaseRecorder.save`` writes) as a
    duration track per phase under a process of their own, named for
    the monotonic clock they keep (a ring's records may keep a sim
    partition's virtual clock); every other record as ``chrome_trace``
    draws it."""
    import numpy as np

    from pbs_tpu_torch.obs import phases
    from pbs_tpu_torch.obs.trace import chrome_trace

    recs = np.asarray(recs).reshape(-1, 8)
    is_phase = (recs[:, 1] >> 8) == phases.PHASE_CLASS
    doc = chrome_trace(recs[~is_phase])
    if is_phase.any():
        names: list[str] = []
        side = phases.sidecar_path(path)
        if os.path.exists(side):
            with open(side) as f:
                names = json.load(f)["names"]
        doc["traceEvents"] += phases.chrome_trace(
            recs[is_phase], names, pid=1)["traceEvents"]
    return doc


def _load_spans(path: str, rids_path: str | None):
    """Span artifacts from an obs dir (``gateway demo --obs``) or a bare
    spans.npy + sidecar."""
    import numpy as np

    from pbs_tpu_torch.obs.spans import SpanAssembler, load_span_artifacts

    if os.path.isdir(path):
        recs, side = load_span_artifacts(path)
    else:
        recs = np.load(path)
        side_path = rids_path or os.path.join(
            os.path.dirname(os.path.abspath(path)), "spans.json")
        with open(side_path) as f:
            side = json.load(f)
    asm = SpanAssembler(recs, side.get("rids", []),
                        side.get("members"), side.get("tenant_table"))
    return asm, side


def _cmd_trace_spans(args) -> int:
    """``trace spans OBS`` — reconstruct request timelines from drained
    SPAN_* records: per-rid chains (text), stable JSON (--json), or
    Chrome trace-event JSON (--chrome)."""
    from pbs_tpu_torch.obs.spans import SPAN_ARGS
    from pbs_tpu_torch.obs.trace import Ev

    if not args.spans_path:
        print("pbst-torch: trace spans needs a path (obs dir or "
              "spans.npy)", file=sys.stderr)
        return 2
    asm, side = _load_spans(args.spans_path, args.rids)
    if getattr(args, "chrome", None):
        with open(args.chrome, "w") as f:
            json.dump(asm.chrome_trace(), f)
        print(f"wrote {len(asm.chains)} span(s) to {args.chrome} "
              "(chrome://tracing / Perfetto)")
        return 0
    if args.json:
        doc = {
            "version": 1,
            "spans": asm.summary(),
            "problems": asm.validate(),
            "chains": {
                rid: [[ts, Ev(ev).name, *a] for ts, ev, *a in chain]
                for rid, chain in sorted(asm.chains.items())
            },
        }
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0
    members = side.get("members", [])
    tenant_table = side.get("tenant_table", [])

    def _member(m: int) -> str:
        return members[m] if 0 <= m < len(members) else f"m{m}"

    for rid, chain in sorted(asm.chains.items()):
        slot = chain[0][2]
        tenant = (tenant_table[slot] if 0 <= slot < len(tenant_table)
                  else f"tenant{slot}")
        print(f"span {rid} tenant={tenant}")
        for ts, ev, *a in chain:
            nargs, member_at = SPAN_ARGS.get(int(ev), (len(a), None))
            shown = a[:nargs]
            if member_at is None:  # HANDOFF: from -> to member pair
                member = " -> ".join(_member(m) for m in shown[:2])
            else:
                member = _member(shown[member_at]) \
                    if member_at < len(shown) else ""
            print(f"  [{ts / 1e9:.6f}] {Ev(ev).name:<14} "
                  f"{' '.join(map(str, shown))}"
                  f"{'  @' + member if member else ''}")
    problems = asm.validate()
    for p in problems:
        print(f"PROBLEM: {p}")
    return 1 if problems else 0


def cmd_slo(args) -> int:
    """``slo report OBS`` — per-tenant p50/p95/p99 + SLO burn-rate from
    span artifacts, stable JSON on stdout."""
    asm, side = _load_spans(args.obs, None)
    report = asm.slo_report(tenants=side.get("tenants"),
                            run_meta=side.get("run"))
    if side.get("lost"):
        report["lost_records"] = int(side["lost"])
    print(json.dumps(report, indent=1, sort_keys=True))
    return 0


def cmd_ckpt_info(args) -> int:
    """Inspect a checkpoint directory (xl save artifacts)."""
    with open(f"{args.path}/manifest.json") as f:
        m = json.load(f)
    print(json.dumps(
        {k: m[k] for k in
         ("version", "n_leaves", "bytes", "has_telemetry", "metadata",
          "wall_time")},
        indent=1))
    return 0


def cmd_sched_credit(args) -> int:
    """xl sched-credit analog over a store db: -d job [-w W] [-c C]
    [-t TSLICE_US]. The controller watches these keys."""
    from pbs_tpu_torch.store import Store

    s = Store(persist_path=args.db)
    base = f"/jobs/{args.domain}/sched"
    if args.weight is None and args.cap is None and args.tslice_us is None:
        print(json.dumps({
            "weight": s.read(f"{base}/weight", 256),
            "cap": s.read(f"{base}/cap", 0),
            "tslice_us": s.read(f"{base}/tslice_us", 100),
        }))
        return 0
    # Validate everything before writing anything: a rejected update
    # must leave the store untouched (operators assume all-or-nothing).
    # Bounds are the dispatch-legal band (sched/base.py) so the CLI can
    # never store a slice the schedulers would clamp away.
    from pbs_tpu_torch.sched.base import TSLICE_MAX_US, TSLICE_MIN_US

    if args.tslice_us is not None and not (
            TSLICE_MIN_US <= args.tslice_us <= TSLICE_MAX_US):
        print(f"pbst-torch: tslice out of bounds "
              f"[{TSLICE_MIN_US}, {TSLICE_MAX_US}] us", file=sys.stderr)
        return 1
    t = s.transaction()
    if args.weight is not None:
        t.write(f"{base}/weight", args.weight)
    if args.cap is not None:
        t.write(f"{base}/cap", args.cap)
    if args.tslice_us is not None:
        t.write(f"{base}/tslice_us", args.tslice_us)
    t.commit()
    return 0


def cmd_mon(args) -> int:
    """xenmon analog: live per-job sched history from file-backed rings."""
    import time

    from pbs_tpu_torch.obs.mon import Monitor

    mon = Monitor(args.meta, window_ns=int(args.window * 1e9))
    hdr = (f"{'slot':>4} {'job':<12} {'ctx':<16} {'weight':>6} "
           f"{'cpu%':>7} {'gotten_ms':>10} {'execs':>7} {'wakes':>7}")
    n_iter = args.iterations if args.iterations > 0 else 10**9
    try:
        for i in range(n_iter):
            mon.refresh_meta()
            mon.poll()
            sys.stdout.write("\x1b[2J\x1b[H" if args.clear else "")
            print(f"pbst mon — partition={mon.meta.get('partition')} "
                  f"window={args.window}s "
                  f"records={mon.history.records_seen}")
            print(hdr)
            for r in mon.rows(windows=args.windows):
                print(f"{r['slot']:>4} {r['job']:<12} {r['ctx']:<16} "
                      f"{(r['weight'] if r['weight'] is not None else ''):>6} "
                      f"{r['cpu_pct']:>7.2f} {r['gotten_ms']:>10.3f} "
                      f"{r['execs']:>7} {r['wakes']:>7}")
            if i + 1 < n_iter:  # no pointless sleep after the last frame
                time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_oprofile(args) -> int:
    """xenoprof/opreport analog over a live system's file-backed
    ledger: passive-attach (zero cooperation from the profiled
    process, like xenoprof passive domains —
    xen-4.2.1/xen/common/xenoprof.c), sample for --seconds at
    --period, then print the flat per-job profile."""
    import time

    from pbs_tpu_torch.obs.oprofile import ProfileSession

    # Passive-only monitor session: no hosting partition, no timer —
    # this loop drives sample_once with real timestamps.
    sess = ProfileSession(None)
    try:
        sess.add_passive(args.name, args.ledger)
        t_end = time.monotonic() + args.seconds
        try:
            while True:
                sess.sample_once(time.monotonic_ns())
                if time.monotonic() >= t_end:
                    break
                time.sleep(args.period / 1e3)
        except KeyboardInterrupt:
            pass  # partial profile is still a profile (cmd_top contract)
        rep = sess.report()
    finally:
        sess.close()
    print(f"{'job':<28} {'samples':>8} {'lost':>5} {'device_ms':>10} "
          f"{'stall%':>7} {'coll_ms':>8} {'last_step':>9}")
    for job, r in sorted(rep.items()):
        print(f"{job:<28} {r['samples']:>8} {r['lost']:>5} "
              f"{r['device_ms']:>10.3f} {r['stall_pct']:>7.2f} "
              f"{r['collective_wait_ms']:>8.3f} {r['last_step']:>9}")
    return 0


def cmd_perfc(args) -> int:
    """xenperf analog: format a published obs dump's software counters."""
    from pbs_tpu_torch.obs.dumpfile import read_obs_dump

    snap = read_obs_dump(args.file)
    for name, val in snap.get("perfc", {}).items():
        print(f"{name:<40} {val:>12}")
    return 0


def cmd_perf(args) -> int:
    """Hot-path microbenchmark harness (pbs_tpu_torch.perf): run the
    named benches (default: all) in python or --native mode, print
    stable JSON or a table, optionally gate against the checked-in
    baseline (--check fails only on >= --threshold ns/op regressions,
    compared like-with-like per mode) or refresh it
    (--update-baseline)."""
    from pbs_tpu_torch.perf import (
        format_report,
        load_baseline,
        run_benches,
        save_baseline,
    )
    from pbs_tpu_torch.perf.report import main_check
    from pbs_tpu_torch.runtime import native as native_mod

    if args.update_baseline and args.quick:
        print("pbst-torch: refusing to write a --quick-only baseline "
              "(--update-baseline measures both op counts itself)",
              file=sys.stderr)
        return 2
    if not native_mod.available():
        # Diagnosable, never silent: say WHY the fast paths are off,
        # every run.
        reason = native_mod.unavailable_reason()
        if args.native:
            print(f"pbst-torch: --native requested but the native "
                  f"runtime is unavailable: {reason}", file=sys.stderr)
            return 2
        print(f"pbst-torch: note: native runtime unavailable ({reason}); "
              "python mode is also the production path on this host",
              file=sys.stderr)
    try:
        results = run_benches(args.benches, quick=args.quick,
                              native=args.native)
    except KeyError as e:
        print(f"pbst-torch: {e.args[0]}", file=sys.stderr)
        return 2
    if args.update_baseline:
        # Both op counts: --check compares like-with-like (quick
        # counts carry systematic per-call-overhead offsets).
        quick_results = run_benches(args.benches, quick=True,
                                    native=args.native)
        path = save_baseline(results, args.baseline,
                             quick_results=quick_results)
        print(f"wrote baseline {path}")
        return 0
    if args.json:
        print(json.dumps(results, indent=1, sort_keys=True))
    else:
        baseline = None
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError):
            pass  # table renders without the vs_base column
        print(format_report(results, baseline))
    if args.check:
        return main_check(results, args.baseline, args.threshold)
    return 0


def cmd_lockprof(args) -> int:
    """xenlockprof analog: per-lock contention stats, worst wait first."""
    from pbs_tpu_torch.obs.dumpfile import read_obs_dump

    snap = read_obs_dump(args.file)
    print(f"{'lock':<16} {'acquires':>10} {'contended':>10} "
          f"{'wait_ms':>10} {'hold_ms':>10} {'maxwait_us':>10}")
    for r in snap.get("lockprof", []):
        print(f"{r['name']:<16} {r['acquires']:>10} {r['contended']:>10} "
              f"{r['wait_ns'] / 1e6:>10.3f} {r['hold_ns'] / 1e6:>10.3f} "
              f"{r['max_wait_ns'] / 1e3:>10.1f}")
    return 0


def cmd_lockdep(args) -> int:
    """Lock-order report (the lockdep analog): established order graph
    and any AB-BA violations from a published obs dump."""
    from pbs_tpu_torch.obs.dumpfile import read_obs_dump

    snap = read_obs_dump(args.file).get("lockdep", {})
    if getattr(args, "dump_graph", False):
        from pbs_tpu_torch.obs.lockdep import export_graph

        # Stable export for static/dynamic cross-checking
        # (``check --lockdep-graph``): an artifact, not a gate.
        print(json.dumps(export_graph(snap), indent=1, sort_keys=True))
        return 0
    print(f"classes: {len(snap.get('classes', []))}  "
          f"checked edges: {snap.get('checked_edges', 0)}  "
          f"violations: {len(snap.get('violations', []))}")
    for a, bs in snap.get("edges", {}).items():
        print(f"  {a} -> {', '.join(bs)}")
    for v in snap.get("violations", []):
        print(f"VIOLATION: taking {v['taking']!r} while holding "
              f"{v['holding']!r}; established "
              f"{' -> '.join(v['established_order'])}")
    return 1 if snap.get("violations") else 0


def cmd_selftest(args) -> int:
    """Perf canary of the telemetry hot paths (x86_tests.c analog):
    order-of-magnitude regression gates on the per-quantum costs, on
    every tier of the native runtime the host reaches."""
    from pbs_tpu_torch.obs.selftest import run_selftest

    results = run_selftest(n=args.n)
    for r in results:
        print(r.row())
    return 0 if all(r.ok for r in results) else 1


def cmd_params(args) -> int:
    """Effective boot-param registry (name=value per line)."""
    from pbs_tpu_torch.utils import params as params_mod

    if args.file:
        from pbs_tpu_torch.obs.dumpfile import read_obs_dump

        vals = read_obs_dump(args.file).get("params", {})
    else:
        # Import the subsystems that declare params so a standalone
        # invocation sees the full registry (param declaration happens
        # at module import, like Xen's link-time param sections).
        import pbs_tpu_torch.obs.lockprof  # noqa: F401
        import pbs_tpu_torch.obs.trace  # noqa: F401
        import pbs_tpu_torch.runtime.job  # noqa: F401
        import pbs_tpu_torch.runtime.partition  # noqa: F401

        if args.cmdline:
            for tok in params_mod.parse_cmdline(args.cmdline):
                print(f"pbst-torch: bad param {tok!r}", file=sys.stderr)
        vals = params_mod.dump()
    for name, val in vals.items():
        print(f"{name}={json.dumps(val)}")
    return 0


def _parse_knob_value(raw: str):
    """CLI value -> python value. JSON first (ints stay ints, floats
    floats); anything unparseable passes through as the raw string so
    the REGISTRY rejects it with a typed problem — ``knobs set
    x=banana`` must exercise the malformed-push path, not argparse."""
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def cmd_knobs(args) -> int:
    """Typed knob registry + atomic hot-reload channel. ``list`` dumps
    the declarations; ``get``/``set``/``watch`` ride a file-backed
    channel (``--channel``); ``init`` creates one; ``load-profile``
    pushes a tuned profile as a knob file. Exit 0 ok / 1 rejected push
    or watch problem / 2 usage error."""
    from pbs_tpu_torch import knobs as registry
    from pbs_tpu_torch.knobs.channel import KnobChannel
    from pbs_tpu_torch.knobs.registry import KnobError

    def open_channel(writable: bool, create: bool = False):
        if not args.channel:
            print("pbst-torch: this action needs --channel PATH",
                  file=sys.stderr)
            return None
        if create and not os.path.exists(args.channel):
            return KnobChannel.create(args.channel)
        return KnobChannel.attach(args.channel, writable=writable)

    if args.action == "list":
        try:
            if args.json:
                doc = registry.schema()
                if args.channel:
                    ch = KnobChannel.attach(args.channel)
                    gen, vals = ch.snapshot()
                    doc["channel"] = {"path": args.channel,
                                      "generation": gen, "values": vals}
                print(json.dumps(doc, indent=1, sort_keys=True))
                return 0
            vals = None
            if args.channel:
                _, vals = KnobChannel.attach(args.channel).snapshot()
        except (KnobError, OSError) as e:
            print(f"pbst-torch: bad --channel {args.channel!r}: {e}",
                  file=sys.stderr)
            return 2
        print(f"{'name':<42} {'type':<6} {'unit':<10} "
              f"{'default':>12} {'range':<24} {'value':>12}")
        for k in registry.all_knobs():
            cur = vals.get(k.name, k.default) if vals is not None \
                else registry.get(k.name)
            print(f"{k.name:<42} {k.kind:<6} {k.unit or '-':<10} "
                  f"{k.default:>12} "
                  f"{f'[{k.lo}, {k.hi}]':<24} {cur:>12}")
        return 0

    if args.action == "init":
        if not args.channel:
            print("pbst-torch: init needs --channel PATH", file=sys.stderr)
            return 2
        try:
            # Always a fresh create: init is also the recovery path
            # for a wedged channel (writer crashed mid-push), so it
            # must rewrite the file, not attach to the wreck.
            ch = KnobChannel.create(args.channel)
        except (KnobError, OSError) as e:
            print(f"pbst-torch: bad --channel {args.channel!r}: {e}",
                  file=sys.stderr)
            return 2
        gen, vals = ch.snapshot()
        print(f"knob channel {args.channel}: {len(vals)} knob(s), "
              f"generation {gen}")
        return 0

    if args.action == "get":
        if not args.items:
            print("pbst-torch: get needs at least one knob name",
                  file=sys.stderr)
            return 2
        try:
            ch = open_channel(writable=False) if args.channel else None
        except (KnobError, OSError) as e:
            print(f"pbst-torch: bad --channel {args.channel!r}: {e}",
                  file=sys.stderr)
            return 2
        out = {}
        for name in args.items:
            if not registry.exists(name):
                print(f"pbst-torch: unknown knob {name!r}",
                      file=sys.stderr)
                return 2
            out[name] = ch.get(name) if ch is not None \
                else registry.get(name)
        if args.json:
            print(json.dumps(out, indent=1, sort_keys=True))
        else:
            for name, v in out.items():
                print(f"{name}={v}")
        return 0

    if args.action == "set":
        if not args.items:
            print("pbst-torch: set needs NAME=VALUE arguments",
                  file=sys.stderr)
            return 2
        updates = {}
        for item in args.items:
            name, eq, raw = item.partition("=")
            if not eq:
                print(f"pbst-torch: set takes NAME=VALUE, got {item!r}",
                      file=sys.stderr)
                return 2
            updates[name] = _parse_knob_value(raw)
        try:
            ch = open_channel(writable=True, create=True)
        except (KnobError, OSError) as e:
            print(f"pbst-torch: bad --channel {args.channel!r}: {e}",
                  file=sys.stderr)
            return 2
        if ch is None:
            return 2
        try:
            gen = ch.push(updates)
        except KnobError as e:
            print("pbst-torch: knob push REJECTED (atomic — nothing "
                  "applied):", file=sys.stderr)
            for p in e.problems:
                print(f"  {p}", file=sys.stderr)
            return 1
        print(f"applied {len(updates)} knob(s) at generation {gen}")
        return 0

    if args.action == "watch":
        try:
            ch = open_channel(writable=False)
        except (KnobError, OSError) as e:
            print(f"pbst-torch: bad --channel {args.channel!r}: {e}",
                  file=sys.stderr)
            return 2
        if ch is None:
            return 2

        def on_change(gen, values):
            if args.json:
                print(json.dumps({"generation": gen, "values": values},
                                 sort_keys=True), flush=True)
            else:
                print(f"generation {gen}:", flush=True)
                for k in sorted(values):
                    print(f"  {k}={values[k]}", flush=True)

        try:
            n = ch.watch(on_change, timeout_s=args.timeout,
                         max_events=args.max_events)
        except KnobError as e:
            # e.g. snapshot retries exhausted against a wedged writer.
            print(f"pbst-torch: watch failed: {e}", file=sys.stderr)
            return 1
        print(f"watch done: {n} update(s)", file=sys.stderr)
        return 0

    if args.action == "load-profile":
        from pbs_tpu_torch.knobs.profile import profile_knob_document
        from pbs_tpu_torch.sched import tune

        if not args.items:
            print("pbst-torch: load-profile needs a workload name "
                  f"({tune.tuned_workloads(args.tuned_dir)})",
                  file=sys.stderr)
            return 2
        try:
            prof = tune.load_profile(args.items[0], args.tuned_dir)
            updates = profile_knob_document(prof)
        except (OSError, ValueError, KeyError, KnobError) as e:
            print(f"pbst-torch: bad tuned profile {args.items[0]!r}: {e}",
                  file=sys.stderr)
            return 2
        if not args.channel:
            # Dry surface: show what the profile stands for.
            for k in sorted(updates):
                print(f"{k}={updates[k]}")
            return 0
        try:
            ch = open_channel(writable=True, create=True)
        except (KnobError, OSError) as e:
            print(f"pbst-torch: bad --channel {args.channel!r}: {e}",
                  file=sys.stderr)
            return 2
        try:
            gen = ch.push(updates)
        except KnobError as e:
            print(f"pbst-torch: profile push REJECTED: {e}",
                  file=sys.stderr)
            return 1
        print(f"profile {args.items[0]!r}: {len(updates)} knob(s) "
              f"live at generation {gen}")
        return 0

    print(f"pbst-torch: unknown knobs action {args.action!r}",
          file=sys.stderr)
    return 2


def cmd_demo(args) -> int:
    """The two-tenant sim demo end to end: a memory-bound and a
    compute-bound tenant under the feedback policy."""
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import SimBackend, SimProfile

    be = SimBackend()
    part = Partition("demo", source=be, scheduler=args.scheduler,
                     ledger_path=args.ledger)
    fb = FeedbackPolicy(part)
    be.register("train", SimProfile.steady(
        step_time_ns=200_000, stall_frac=0.5, collective_wait_ns=2_000))
    be.register("serve", SimProfile.steady(
        step_time_ns=50_000, stall_frac=0.02, collective_wait_ns=500))
    part.add_job(Job("train", params=SchedParams(weight=512)))
    part.add_job(Job("serve", params=SchedParams(weight=256)))
    part.run(until_ns=int(args.seconds * 1e9))
    print(json.dumps(part.dump(), indent=1))
    print(json.dumps({"feedback": fb.dump()}, indent=1))
    return 0


def cmd_gateway(args) -> int:
    """Serving front-door surface.

    ``gateway demo``  — the fault-free gateway scenario over the sim
    workload catalog (seeded arrivals, simulated backends): prints
    admission/fairness/queue-delay stats per SLO class.
    ``gateway demo --federated`` — the same arrivals through the
    FEDERATED tier (``--gateways`` members, consistent-hash placement,
    leased admission): no injected faults, but the seeded drain +
    rejoin schedule still runs, so the handoff/remap machinery shows
    in the stats.
    ``gateway stats --ledger F`` — render a gateway telemetry ledger
    (the per-class slots) the way ``dump`` renders a partition's.
    """
    if args.action == "stats":
        from pbs_tpu_torch.gateway.gateway import GW_LEDGER_SLOTS
        from pbs_tpu_torch.telemetry import Counter, Ledger

        if args.ledger is None:
            print("pbst-torch: gateway stats needs --ledger",
                  file=sys.stderr)
            return 2
        led = Ledger.file_backed(args.ledger, readonly=True)
        # Histogram sidecar: quantiles from the SAME log2 histograms
        # ``slo report`` and the gateway's own shed/boost decisions
        # read — not a cumulative-sum mean that hides the tail. Falls
        # back to means on a ledger without one.
        hist = None
        if os.path.exists(args.ledger + ".hist.meta.json"):
            from pbs_tpu_torch.obs.spans import LatencyHistograms

            hist = LatencyHistograms.attach(args.ledger + ".hist")
        src_line = _fmt_source(_load_meta(args.ledger))
        if src_line:
            print(src_line)
        tail_hdr = (
            f"{'qdelay_p50_ms':>14} {'qdelay_p99_ms':>14} "
            f"{'e2e_p99_ms':>11}" if hist is not None else
            f"{'avg_qdelay_ms':>14} {'avg_service_ms':>15}")
        print(f"{'class':<14} {'completed':>10} {'dispatched':>10} "
              f"{'shed':>6} {'requeued':>8} {'cost':>8} " + tail_hdr)
        for cls, slot in GW_LEDGER_SLOTS.items():
            snap = led.snapshot(slot)
            dispatched = int(snap[Counter.SCHED_COUNT])
            completed = int(snap[Counter.STEPS_RETIRED])
            if hist is not None:
                tail = (
                    f"{hist.class_quantile(cls, 'queue', 0.50) / 1e6:>14.3f} "
                    f"{hist.class_quantile(cls, 'queue', 0.99) / 1e6:>14.3f} "
                    f"{hist.class_quantile(cls, 'e2e', 0.99) / 1e6:>11.3f}")
            else:
                qdelay = (int(snap[Counter.RUNQ_WAIT_NS]) / 1e6
                          / max(1, dispatched))
                service = (int(snap[Counter.DEVICE_TIME_NS]) / 1e6
                           / max(1, completed))
                tail = f"{qdelay:>14.3f} {service:>15.3f}"
            print(f"{cls:<14} {completed:>10} "
                  f"{dispatched:>10} "
                  f"{int(snap[Counter.COMPILES]):>6} "
                  f"{int(snap[Counter.YIELDS]):>8} "
                  f"{int(snap[Counter.TOKENS]):>8} " + tail)
        return 0
    # demo: the chaos harness with no faults and no backend kill.
    from pbs_tpu_torch.faults import FaultPlan
    from pbs_tpu_torch.gateway import run_gateway_chaos

    if args.processes:
        from pbs_tpu_torch.gateway.procfed import run_process_chaos

        report = run_process_chaos(
            workload=args.workload, seed=args.seed,
            n_gateways=args.gateways,
            backends_per_gateway=args.backends,
            n_tenants=args.tenants, ticks=args.ticks)
        if args.json:
            print(json.dumps(report, indent=1, sort_keys=True))
            return 0 if report["ok"] else 1
        st = report["stats"]
        proc = report["process"]
        print(f"process gateway demo workload={report['workload']} "
              f"seed={report['seed']} gateways={report['gateways']} "
              f"tenants={report['tenants']} ticks={report['ticks']}")
        print(f"admitted={st['admitted']} completed={st['completed']} "
              f"handoffs={st['handoffs']} shed={st['shed']}")
        for name, m in proc["members"].items():
            print(f"  {name:<8} pid={m['pid']:>7} "
                  f"state={m['state']:<10} "
                  f"restarts={m['restarts']} depth={m['depth']}")
        for prob in report["problems"]:
            print(f"  PROBLEM: {prob}")
        # Fault-free ⇒ disarmed ⇒ the run carries a digest.
        print(f"digest={report['digest']}")
        print("ok" if report["ok"] else "FAILED")
        return 0 if report["ok"] else 1

    if args.federated:
        from pbs_tpu_torch.gateway import run_federation_chaos

        report = run_federation_chaos(
            workload=args.workload, seed=args.seed,
            n_gateways=args.gateways,
            backends_per_gateway=args.backends,
            n_tenants=args.tenants,
            ticks=args.ticks, plan=FaultPlan(seed=args.seed),
            obs_dir=args.obs)
        if args.json:
            print(json.dumps(report, indent=1, sort_keys=True))
            return 0 if report["ok"] else 1
        st = report["stats"]
        print(f"federated gateway demo workload={report['workload']} "
              f"seed={report['seed']} gateways={report['gateways']} "
              f"tenants={report['tenants']} ticks={report['ticks']}")
        print(f"admitted={st['admitted']} completed={st['completed']} "
              f"handoffs={st['handoffs']} remaps={st['remaps']} "
              f"shed={st['shed']}")
        for name, m in st["members"].items():
            print(f"  {name:<8} admitted={m['admitted']:>5} "
                  f"adopted={m['adopted']:>4} queued={m['queued']:>4} "
                  f"inflight={m['inflight']:>3}"
                  f"{'  draining' if m['draining'] else ''}")
        _print_federation_events(report, "PROBLEM")
        print("ok" if report["ok"] else "FAILED")
        return 0 if report["ok"] else 1

    report = run_gateway_chaos(
        workload=args.workload, seed=args.seed,
        n_backends=args.backends, n_tenants=args.tenants,
        ticks=args.ticks, plan=FaultPlan(seed=args.seed),
        ledger_path=args.ledger, kill_backend=False,
        obs_dir=args.obs)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
        return 0 if report["ok"] else 1
    st = report["stats"]
    print(f"gateway demo workload={report['workload']} "
          f"seed={report['seed']} backends={report['backends']} "
          f"tenants={report['tenants']} ticks={report['ticks']}")
    print(f"admitted={st['admitted']} completed={st['completed']} "
          f"shed_rate={st['shed_rate']} sheds={st['shed']}")
    for cls, c in st["classes"].items():
        print(f"  {cls:<12} queued={c['queued']:>4} "
              f"qdelay_p50_ms={c['qdelay_p50_ns'] / 1e6:>8.3f} "
              f"qdelay_p99_ms={c['qdelay_p99_ns'] / 1e6:>8.3f} "
              f"latency_p99_ms={c['latency_p99_ns'] / 1e6:>8.3f}")
    for prob in report["problems"]:
        print(f"  PROBLEM: {prob}")
    print("ok" if report["ok"] else "FAILED")
    return 0 if report["ok"] else 1


def cmd_quantize(args) -> int:
    """Offline int8 weight-only quantization of a param checkpoint:
    reads a checkpoint holding a transformer/MoE param tree, writes a
    new checkpoint with int8 {'q','s'} leaves (models.quant layout)
    for the serving forwards, and prints the byte accounting. Runs on
    the host: the leaves load as CPU tensors."""
    from pbs_tpu_torch.ckpt import load_checkpoint, save_checkpoint
    from pbs_tpu_torch.models.quant import quantize_weights, quantized_nbytes

    state, meta = load_checkpoint(args.src)
    params = None
    if isinstance(state, dict):
        params = state if "embed" in state else state.get("params")
    if not isinstance(params, dict) or "embed" not in params:
        print("pbst-torch: checkpoint does not hold a param tree "
              "(expected 'embed'/'layers'/... at the top level or "
              "under 'params')", file=sys.stderr)
        return 1
    before = quantized_nbytes(params)
    qp = quantize_weights(params)
    after = quantized_nbytes(qp)
    save_checkpoint(args.dst, qp, metadata={
        **(meta or {}), "quantized": "int8-weight-only"})
    print(json.dumps({
        "src": args.src, "dst": args.dst,
        "bytes_before": before, "bytes_after": after,
        "ratio": round(after / max(before, 1), 4),
    }))
    return 0


def cmd_check(args) -> int:
    """Static invariant checker suite (docs/ANALYSIS.md): lock
    discipline, time-unit consistency, scheduler-ops conformance,
    counter-API usage. Exit 0 clean / 1 findings / 2 usage error."""
    from pbs_tpu_torch.analysis import (
        ALL_PASSES,
        changed_check_files,
        check_paths,
        format_human,
        list_suppressions,
        load_dynamic_graph,
    )

    if args.list_passes:
        for cls in ALL_PASSES:
            print(f"{cls.id:<16} rules: {', '.join(cls.rules)}")
            print(f"{'':<16} {cls.description}")
        return 0
    if args.list_suppressions:
        sups = list_suppressions(args.paths)
        if args.format == "json":
            print(json.dumps({"version": 1, "count": len(sups),
                              "suppressions": sups},
                             indent=1, sort_keys=True))
        else:
            for s in sups:
                scope = "file-wide" if s["scope"] == "file" else "line"
                print(f"{s['path']}:{s['line']}: "
                      f"[{', '.join(s['rules'])}] ({scope}) -- "
                      f"{s['justification'] or 'NO JUSTIFICATION'}")
            print(f"{len(sups)} suppression(s)")
        return 0
    dynamic = None
    if args.lockdep_graph:
        try:
            dynamic = load_dynamic_graph(args.lockdep_graph)
        except (OSError, ValueError, KeyError) as e:
            print(f"pbst-torch: bad --lockdep-graph "
                  f"{args.lockdep_graph!r}: {e}", file=sys.stderr)
            return 2
    paths = args.paths
    if args.changed:
        try:
            paths = changed_check_files(args.changed, args.paths)
        except ValueError as e:
            print(f"pbst-torch: bad --changed {args.changed!r}: {e}",
                  file=sys.stderr)
            return 2
        if not paths:
            # A legitimately empty change set is clean, not a usage
            # error — this is the pre-commit fast path.
            print(f"pbst-torch check: no checkable files changed vs "
                  f"{args.changed} under {args.paths}")
            return 0
    try:
        result = check_paths(paths, passes=args.passes,
                             dynamic_graph=dynamic)
    except KeyError as e:
        print(f"pbst-torch: {e.args[0]}", file=sys.stderr)
        return 2
    if result.files_scanned == 0:
        print(f"pbst-torch: no checkable files under {paths}",
              file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(result.as_dict(), indent=1, sort_keys=True))
    else:
        print(format_human(result))
    return result.exit_code


def check_entry() -> None:
    """Console entry ``pbst-torch-check``: exactly ``pbst-torch check
    ...`` without the subcommand word."""
    sys.exit(main(["check", *sys.argv[1:]]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pbst-torch",
                                description="PBS-T port command line")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser(
        "serve-demo", help="continuous-batching serving demo")
    sp.add_argument("--requests", type=int, default=9)
    sp.add_argument("--slots", type=int, default=2)
    sp.add_argument("--prefix-cache", type=int, default=4)
    sp.add_argument("--device", default=None,
                    help="torch device; default: the card (raises without "
                         "one). 'cpu' runs the plain versions on the host")
    sp.set_defaults(fn=cmd_serve_demo)

    sp = sub.add_parser(
        "serve",
        help="sharded serving tier: 'demo' runs a rule-partitioned "
             "backend (--disagg: prefill/decode pools) behind the "
             "gateway; 'stats' prints the partition table + audit")
    sp.add_argument("action", choices=["demo", "stats"])
    sp.add_argument("--requests", type=int, default=6)
    sp.add_argument("--slots", type=int, default=2)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--disagg", action="store_true",
                    help="demo the prefill/decode disaggregated "
                         "backend instead of the single-pool one")
    sp.add_argument("--hw", action="store_true",
                    help="demo: arm the live hardware-counter plane "
                         "on the gateway (stats gain the active tier "
                         "+ sampled totals)")
    sp.add_argument("--device", default=None,
                    help="demo: torch device; default: the card (raises "
                         "without one). 'cpu' runs on the host")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser(
        "chaos", help="seeded fault-injection run (pbs_tpu_torch.faults)")
    sp.add_argument("--workload", default="mixed",
                    help="workload mix (the sim.workload catalog)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--agents", type=int, default=3)
    sp.add_argument("--gateways", type=int, default=3,
                    help="federation members (--plan federation)")
    sp.add_argument("--tenants", type=int, default=4)
    sp.add_argument("--rounds", type=int, default=5)
    sp.add_argument("--plan", default="chaos",
                    help="'chaos', 'rpc', 'gateway', 'federation', "
                         "'crash' (federation + journal-recovered "
                         "kill-9s), 'none', or a FaultPlan JSON path")
    sp.add_argument("--trace", default=None,
                    help="write the fault trace JSONL here")
    sp.add_argument("--obs", default=None, metavar="DIR",
                    help="write span artifacts here (gateway/"
                         "federation plans)")
    sp.add_argument("--no-replication", action="store_true")
    sp.add_argument("--processes", action="store_true",
                    help="members as REAL OS processes (federation/"
                         "crash plans): --plan crash delivers literal "
                         "SIGKILLs, recovery from journal bytes alone")
    sp.add_argument("--selfcheck", action="store_true",
                    help="run twice; digests must match")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=cmd_chaos)

    sp = sub.add_parser("store", help="store ops (xenstore)")
    sp.add_argument("op", choices=["ls", "read", "write", "rm"])
    sp.add_argument("path")
    sp.add_argument("value", nargs="?")
    sp.add_argument("--db", required=True)
    sp.add_argument("--subject", default="operator",
                    help="XSM label presented to the store policy")
    sp.set_defaults(fn=cmd_store)

    def agent_args(sp):
        sp.add_argument("--connect", required=True,
                        help="agent address host:port")
        sp.add_argument("--subject", default="operator",
                        help="XSM subject label")

    sp = sub.add_parser("create", help="create a job on an agent (xl create)")
    sp.add_argument("job")
    agent_args(sp)
    sp.add_argument("--workload", default="sim")
    sp.add_argument("--spec", help="workload spec JSON")
    sp.add_argument("-w", "--weight", type=int)
    sp.add_argument("--max-steps", type=int, dest="max_steps")
    sp.set_defaults(fn=cmd_create)

    sp = sub.add_parser("destroy", help="destroy a job (xl destroy)")
    sp.add_argument("job")
    agent_args(sp)
    sp.set_defaults(fn=cmd_destroy)

    sp = sub.add_parser("pause", help="pause/unpause a job (xl pause)")
    sp.add_argument("job")
    agent_args(sp)
    sp.add_argument("--unpause", action="store_true")
    sp.set_defaults(fn=cmd_pause)

    sp = sub.add_parser("list", help="list jobs on an agent (xl list)")
    agent_args(sp)
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("run", help="drive scheduler rounds on an agent")
    agent_args(sp)
    sp.add_argument("--rounds", type=int, default=100)
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("replicate",
                        help="Remus replication control (tools/remus)")
    sp.add_argument("action", choices=["start", "stop", "status"])
    sp.add_argument("job")
    agent_args(sp)
    sp.add_argument("--peer", default=None, help="backup host:port")
    sp.add_argument("--period", type=float, default=0.5)
    sp.set_defaults(fn=cmd_replicate)

    sp = sub.add_parser("replicas",
                        help="replicas held by a backup host")
    agent_args(sp)
    sp.set_defaults(fn=cmd_replicas)

    sp = sub.add_parser("console",
                        help="stream a job's console (xl console)")
    sp.add_argument("job")
    agent_args(sp)
    sp.add_argument("--since", type=int, default=0)
    sp.add_argument("-f", "--follow", action="store_true")
    sp.add_argument("--interval", type=float, default=0.5)
    sp.set_defaults(fn=cmd_console)

    sp = sub.add_parser("migrate", help="migrate a job (xl migrate)")
    sp.add_argument("job")
    agent_args(sp)
    sp.add_argument("--to", required=True, help="destination host:port")
    sp.add_argument("--workload", default=None,
                    help="override workload (default: from save record)")
    sp.add_argument("--spec", default=None,
                    help="override spec JSON (default: from save record)")
    sp.set_defaults(fn=cmd_migrate)

    sp = sub.add_parser(
        "journal",
        help="inspect a write-ahead gateway journal "
             "(docs/DURABILITY.md)")
    sp.add_argument("action", choices=["dump", "verify"])
    sp.add_argument("path", help="journal file (e.g. gateway.jrnl)")
    sp.add_argument("--json-only", action="store_true",
                    help="suppress the stderr torn-tail warning lines")
    sp.set_defaults(fn=cmd_journal)

    sp = sub.add_parser(
        "sim", help="trace-driven scheduler simulation (pbs_tpu_torch.sim)")
    sp.add_argument("--workload", default="mixed",
                    help="workload mix (the sim.workload catalog)")
    sp.add_argument("--policy", default="feedback",
                    help="policy name, or 'all' for the comparison harness")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--seconds", type=float, default=2.0,
                    help="virtual-time horizon")
    sp.add_argument("--tenants", type=int, default=4)
    sp.add_argument("--executors", type=int, default=1)
    sp.add_argument("--trace", default=None,
                    help="write the JSONL trace here (with --policy all: "
                         "per-policy prefix, <trace>.<policy>.jsonl)")
    sp.add_argument("--json", action="store_true",
                    help="full JSON report instead of the summary")
    sp.add_argument("--native", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="require the native sim dispatch core "
                         "(--no-native pins the pure-Python witness "
                         "engine; default auto rides the C core for "
                         "sweep-mode runs — recorded runs stay on the "
                         "witness unless --native is given)")
    sp.set_defaults(fn=cmd_sim)

    sp = sub.add_parser(
        "hw", help="host hardware-counter plane: probe the ladder, "
                   "record/replay counter windows, score sim-vs-real "
                   "fidelity")
    sp.add_argument("action",
                    choices=["probe", "record", "replay", "fidelity",
                             "report"])
    sp.add_argument("paths", nargs="*",
                    help="replay: window JSONL file(s); report: a "
                         "fidelity JSON file")
    sp.add_argument("--out", default="hw_window.jsonl",
                    help="record: window destination; fidelity: also "
                         "write the report JSON here")
    sp.add_argument("--window", metavar="FILE",
                    help="fidelity: score this recorded window "
                         "(reproducible) instead of recording live")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--ticks", type=int, default=200,
                    help="record/fidelity: serving-pump rounds")
    sp.add_argument("--samples", type=int, default=0,
                    help="replay: digest stream length (0 = 2x the "
                         "window)")
    sp.add_argument("--check", action="store_true",
                    help="replay: demand canonical file bytes + "
                         "byte-identical re-replay")
    sp.add_argument("--strict", action="store_true",
                    help="fidelity: exit 1 when margin < 0")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=cmd_hw)

    sp = sub.add_parser(
        "tune", help="simulation-driven policy autotuning")
    sp.add_argument("--workload", default="all",
                    help="workload class or 'all' (the sim catalog)")
    sp.add_argument("--policy", default="feedback",
                    help="policy whose constants to search "
                         "(feedback | atc)")
    sp.add_argument("--seed", type=int, default=0,
                    help="base seed for sha256 per-cell seed derivation")
    sp.add_argument("--workers", type=int, default=1,
                    help="sweep worker processes (1 = inline)")
    sp.add_argument("--quick", action="store_true",
                    help="reduced space/rungs (the quick smoke)")
    sp.add_argument("--check", action="store_true",
                    help="replay every tuned profile's score grid; "
                         "exit 1 on any digest mismatch")
    sp.add_argument("--write", action="store_true",
                    help="emit tuned profiles to the tuned dir")
    sp.add_argument("--tuned-dir", default=None, dest="tuned_dir",
                    help="profile directory (default: the checked-in "
                         "pbs_tpu_torch/sched/tuned/)")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=cmd_tune)

    sp = sub.add_parser(
        "autopilot", help="shadow-replay self-tuning loop "
                          "(docs/AUTOPILOT.md)")
    sp.add_argument("action", choices=["run", "status", "history"])
    sp.add_argument("--demo", action="store_true",
                    help="run: the self-contained seeded demo loop "
                         "(virtual clock, ≤5 s)")
    sp.add_argument("--pathological", action="store_true",
                    help="run --demo: inject the adversarially bad "
                         "candidate (demonstrates guarded rollback)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--ticks", type=int, default=260)
    sp.add_argument("--fidelity", action="store_true",
                    help="run --demo: append the sim-vs-real fidelity "
                         "leg (docs/HWTELEM.md) — records a live "
                         "counter window on the serving pump unless "
                         "--fidelity-window is given")
    sp.add_argument("--fidelity-window", metavar="FILE",
                    dest="fidelity_window",
                    help="score this recorded window instead of "
                         "sampling live (deterministic; the smoke "
                         "path)")
    sp.add_argument("--out", metavar="FILE",
                    help="run: also write the report JSON here")
    sp.add_argument("--state", metavar="FILE",
                    help="status/history: report written by "
                         "`autopilot run --demo --out FILE`")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=cmd_autopilot)

    sp = sub.add_parser(
        "scenarios", help="adversarial scenario frontier + promoted "
                          "regression corpus (docs/SCENARIOS.md)")
    sp.add_argument("action",
                    choices=["hunt", "promote", "replay", "whatif"])
    sp.add_argument("--demo", action="store_true",
                    help="hunt: the tier-1 smoke shape (tiny "
                         "population/horizons, <=5 s)")
    sp.add_argument("--seed", type=int, default=0,
                    help="hunt seed (sha256-derived streams; same "
                         "seed => byte-identical archive digest)")
    sp.add_argument("--workers", type=int, default=1,
                    help="evaluation worker processes (1 = inline; "
                         "archive digest is worker-count invariant)")
    sp.add_argument("--out", metavar="FILE",
                    help="hunt: also write the archive document here "
                         "(feeds `scenarios promote --archive`)")
    sp.add_argument("--archive", metavar="FILE",
                    help="promote: hunt document written by "
                         "`scenarios hunt --out`")
    sp.add_argument("--axes", default=None,
                    help="promote: comma-separated stress axes "
                         "(default: burn,fairness,slack)")
    sp.add_argument("--corpus", metavar="DIR", default=None,
                    help="promote/replay: corpus directory (default: "
                         "the checked-in pbs_tpu_torch/scenarios/corpus/)")
    sp.add_argument("--check", action="store_true",
                    help="replay: demand byte-identical golden "
                         "digests (the CI regression gate)")
    sp.add_argument("--knobs", metavar="CHANNEL", default=None,
                    help="hunt: adopt a knob-channel file's values "
                         "(scenarios.hunt.* / scenarios.score.w_*) "
                         "before configuring the hunt — pairs with "
                         "a KnobChannel file pushed by the caller")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=cmd_scenarios)
    sp = sub.add_parser(
        "check", help="static invariant checkers (docs/ANALYSIS.md)")
    sp.add_argument("paths", nargs="*", default=["pbs_tpu_torch"],
                    help="files/dirs to check (default: pbs_tpu_torch, "
                         "whose runtime/csrc/*.cc the memmodel passes "
                         "check against their Python mirrors)")
    sp.add_argument("--format", choices=["text", "json"], default="text")
    sp.add_argument("--pass", dest="passes", action="append",
                    metavar="PASS-ID",
                    help="run only this pass (repeatable; default: all)")
    sp.add_argument("--list-passes", action="store_true",
                    help="list passes and rule ids, then exit")
    sp.add_argument("--list-suppressions", action="store_true",
                    help="audit every suppression comment (file:line, "
                         "rules, justification), then exit")
    sp.add_argument("--changed", metavar="REF",
                    help="incremental mode: analyze only files changed "
                         "vs this git ref (pre-commit fast path; "
                         "cross-file analyses see the subset only — "
                         "CI still runs the full tree)")
    sp.add_argument("--lockdep-graph", metavar="GRAPH.json",
                    help="dynamic lock-order graph (obs.lockdep."
                         "export_graph) to cross-check static edges "
                         "against")
    sp.set_defaults(fn=cmd_check)

    def ledger_args(sp):
        sp.add_argument("--ledger", required=True, help="ledger file path")

    sp = sub.add_parser("dump", help="one-shot counter dump ('z' key)")
    ledger_args(sp)
    sp.set_defaults(fn=cmd_dump)

    sp = sub.add_parser("top", help="live telemetry (xentop)")
    ledger_args(sp)
    sp.add_argument("--interval", type=float, default=1.0)
    sp.add_argument("--iterations", type=int, default=0, help="0=forever")
    sp.add_argument("--clear", action="store_true")
    sp.set_defaults(fn=cmd_top)

    sp = sub.add_parser(
        "trace",
        help="format a trace dump (xentrace); 'trace spans OBS' "
             "reconstructs request timelines")
    sp.add_argument("file",
                    help="trace .npy to format, or the literal word "
                         "'spans' for span-timeline mode")
    sp.add_argument("spans_path", nargs="?",
                    help="with 'spans': obs dir (gateway demo --obs) "
                         "or spans.npy")
    sp.add_argument("--rids", metavar="SPANS.json",
                    help="span sidecar when spans_path is a bare .npy "
                         "(default: spans.json next to it)")
    sp.add_argument("--json", action="store_true",
                    help="with 'spans': stable JSON chains instead of "
                         "the text timelines")
    sp.add_argument("--chrome", metavar="OUT.json",
                    help="write Chrome trace-event JSON instead (phase "
                         "records, with their names from the "
                         "X.phases.json beside X.npy, as a track per "
                         "phase)")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser(
        "slo", help="per-tenant SLO report from span artifacts")
    sp.add_argument("action", choices=["report"])
    sp.add_argument("obs", help="obs dir written by gateway demo --obs "
                                "/ chaos --obs")
    sp.set_defaults(fn=cmd_slo)

    sp = sub.add_parser("ckpt-info", help="inspect a checkpoint")
    sp.add_argument("path")
    sp.set_defaults(fn=cmd_ckpt_info)

    sp = sub.add_parser(
        "quantize", help="int8 weight-only quantize a param checkpoint")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp.set_defaults(fn=cmd_quantize)

    sp = sub.add_parser("sched-credit", help="adjust job scheduling")
    sp.add_argument("-d", "--domain", required=True)
    sp.add_argument("-w", "--weight", type=int)
    sp.add_argument("-c", "--cap", type=int)
    sp.add_argument("-t", "--tslice-us", type=int, dest="tslice_us")
    sp.add_argument("--db", required=True)
    sp.set_defaults(fn=cmd_sched_credit)

    sp = sub.add_parser("mon", help="live sched history (xenmon)")
    sp.add_argument("meta", help="partition meta sidecar (<ledger>.meta.json)")

    def _pos_int(v: str) -> int:
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return n

    sp.add_argument("--window", type=float, default=1.0, help="seconds")
    sp.add_argument("--windows", type=_pos_int, default=1,
                    help="windows to aggregate per row (>=1)")
    sp.add_argument("--interval", type=float, default=1.0)
    sp.add_argument("--iterations", type=int, default=0, help="0=forever")
    sp.add_argument("--clear", action="store_true")
    sp.set_defaults(fn=cmd_mon)

    sp = sub.add_parser(
        "oprofile",
        help="passive sampling profile of a live ledger "
             "(xenoprof/opreport)")
    sp.add_argument("--ledger", required=True,
                    help="file-backed ledger of the profiled partition")
    sp.add_argument("--name", default="passive",
                    help="label for the passive domain in the report")
    sp.add_argument("--seconds", type=float, default=2.0)
    sp.add_argument("--period", type=float, default=100.0,
                    help="sampling period in ms")
    sp.set_defaults(fn=cmd_oprofile)

    sp = sub.add_parser("perfc", help="software counter dump (xenperf)")
    sp.add_argument("file", help="obs dump JSON (obs.dumpfile)")
    sp.set_defaults(fn=cmd_perfc)

    sp = sub.add_parser("perf", help="hot-path microbench harness")
    sp.add_argument("--bench", dest="benches", action="append",
                    metavar="NAME",
                    help="run only this bench (repeatable; default: all)")
    sp.add_argument("--quick", action="store_true",
                    help="small op counts (the quick smoke)")
    sp.add_argument("--native", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="bench the native runtime paths instead of "
                         "the pure-Python fallback (--no-native, the "
                         "default, pins python mode); gated against "
                         "the baseline's native_* maps")
    sp.add_argument("--check", action="store_true",
                    help="exit 1 on >= --threshold ns/op regressions "
                         "vs the baseline")
    sp.add_argument("--threshold", type=float, default=2.0,
                    help="regression factor for --check (default 2.0)")
    sp.add_argument("--baseline", default=None,
                    help="baseline JSON (default: the checked-in "
                         "pbs_tpu_torch/perf/baseline.json)")
    sp.add_argument("--update-baseline", action="store_true",
                    dest="update_baseline",
                    help="re-measure and overwrite the baseline")
    sp.add_argument("--json", action="store_true",
                    help="stable JSON report instead of the table")
    sp.set_defaults(fn=cmd_perf)

    sp = sub.add_parser("lockprof", help="lock contention (xenlockprof)")
    sp.add_argument("file", help="obs dump JSON (obs.dumpfile)")
    sp.set_defaults(fn=cmd_lockprof)

    sp = sub.add_parser("lockdep",
                        help="lock-order violations (lockdep)")
    sp.add_argument("file", help="obs dump artifact")
    sp.add_argument("--dump-graph", action="store_true", dest="dump_graph",
                    help="print the order graph in its stable JSON form "
                         "(consumed by check --lockdep-graph)")
    sp.set_defaults(fn=cmd_lockdep)

    sp = sub.add_parser("selftest",
                        help="hot-path perf canary (x86_tests.c)")
    sp.add_argument("-n", type=int, default=2000,
                    help="iterations per canary")
    sp.set_defaults(fn=cmd_selftest)

    sp = sub.add_parser("params", help="boot-param registry dump")
    g = sp.add_mutually_exclusive_group()
    g.add_argument("--file", help="obs dump JSON; default: this process")
    g.add_argument("--cmdline", help="apply a 'k=v k2 no-k3' string first")
    sp.set_defaults(fn=cmd_params)

    sp = sub.add_parser(
        "knobs", help="typed knob registry + atomic hot-reload")
    sp.add_argument("action",
                    choices=["list", "init", "get", "set", "watch",
                             "load-profile"])
    sp.add_argument("items", nargs="*",
                    help="get: knob names; set: NAME=VALUE pairs; "
                         "load-profile: workload class")
    sp.add_argument("--channel", metavar="PATH",
                    help="file-backed knob channel (seqlock ledger "
                         "protocol; created on init/set if missing)")
    sp.add_argument("--timeout", type=float, default=None,
                    help="watch: stop after this many seconds")
    sp.add_argument("--max-events", type=int, default=None,
                    dest="max_events",
                    help="watch: stop after this many updates")
    sp.add_argument("--tuned-dir", default=None, dest="tuned_dir",
                    help="load-profile: profile directory (default: "
                         "the checked-in pbs_tpu_torch/sched/tuned/)")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=cmd_knobs)

    sp = sub.add_parser(
        "gateway", help="serving front door: demo over the sim catalog, "
                        "ledger stats")
    sp.add_argument("action", choices=["demo", "stats"])
    sp.add_argument("--workload", default="mixed",
                    help="workload mix (the sim.workload catalog)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--backends", type=int, default=3,
                    help="backend pool size (per MEMBER with "
                         "--federated)")
    sp.add_argument("--federated", action="store_true",
                    help="drive the federated tier (gateway/federation"
                         ".py) instead of one gateway")
    sp.add_argument("--processes", action="store_true",
                    help="the federated tier with members as REAL OS "
                         "processes, fault-free")
    sp.add_argument("--gateways", type=int, default=3,
                    help="federation members (with --federated)")
    sp.add_argument("--tenants", type=int, default=4)
    sp.add_argument("--ticks", type=int, default=400,
                    help="gateway pump rounds (1 ms of virtual time each)")
    sp.add_argument("--ledger", default=None,
                    help="gateway telemetry ledger file (stats action)")
    sp.add_argument("--obs", default=None, metavar="DIR",
                    help="write span artifacts here for trace spans / "
                         "slo report")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=cmd_gateway)

    sp = sub.add_parser("demo", help="run the two-tenant sim demo")
    sp.add_argument("--scheduler", default="credit")
    sp.add_argument("--seconds", type=float, default=2.0)
    sp.add_argument("--ledger", default=None)
    sp.set_defaults(fn=cmd_demo)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"pbst-torch: not found: {e.filename or e}", file=sys.stderr)
        return 1
    except json.JSONDecodeError as e:
        print(f"pbst-torch: invalid JSON value: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
