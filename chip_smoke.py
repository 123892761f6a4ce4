"""Drive the PyTorch/CUDA port (``pbs_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   — compile every kernel of the port from ``pbs_tpu_torch/ops/csrc``
             (one nvcc per source, all at once) and print the build time
             and each kernel's registers and spills (ptxas).
2. kernels — hold each kernel against its plain PyTorch version on the card,
             on the shapes and with the tolerances printed beside each check,
             and the route each launch took (bf16 inputs TMA can address run
             on the tensor cores, "wgmma"; the rest on the CUDA cores, "simt":
             fp32 inputs, and for the backward an fp32 do).
3. main    — the feedback-scheduling loop at flagship width: one Partition
             with a CudaBackend and a FeedbackPolicy over three tenants (a
             KV-cache serving tenant answering 4 x 128-token prompts, a
             forward-scoring tenant on (4, 1024) tokens through the flash
             kernel, an instrumented-matmul tenant on 4096^3 bf16), checking
             ledger words, kernel FLOP counters, launch counts (every
             launch of kernels 2.1 and 2.4 on the tensor-core route) and the
             adapted slices.
3t. train  — the flagship training step as a micro-stepped Job: a second
             Partition holds the training tenant (remat "dots", attention
             through the flash kernels, 3 micro-batches of (2, 1024) tokens
             per AdamW step, 2 steps) beside the KV-cache serving tenant,
             checking retired steps, ledger tokens, yields at chunk
             boundaries, losses, parameter movement, that every
             backward went through kernels 2.2 and 2.3 and every forward
             through kernel 2.1, all on the tensor-core route.
3m. measured — serve, score, mm and the training Job in one Partition
             under FeedbackPolicy, with a CompileAdmission and CudaBackend
             (profile_every=2): each tenant's first invocation and every
             2nd after it run under torch.profiler, and the stall fraction
             measured from the card's kernels sets HBM_STALL_NS. Checks
             every sample came from the device lane with no profiler
             failure, train measured more memory-bound than mm, mm below
             its roofline estimate, an overflow sample on serve's TOKENS
             that fires once and stays disarmed until rearmed, no compile
             charged to any tenant, and that phase 1's nvcc runs are the
             CompileMeter's compiles; prints each tenant's measured
             fractions and top kernels beside the roofline estimate, its
             final slice, and its sampled and unsampled device time.
3s. engine — the serving engine (``ContinuousBatcher``) on a seeded script of
             24 staggered requests at flagship width, 8 slots: (a) bf16, as a
             Job beside score and mm under FeedbackPolicy + CudaBackend,
             checking completions, ledger TOKENS, prefix hits and that every
             launch of kernels 2.1 and 2.4 took the tensor-core route; (b) an
             fp32 engine token-exact against the lockstep ``make_generate``
             at B=1 (a divergence passes only at a near-tie of the lockstep
             run's top-2 logits); (c) the ``SpeculativeBatcher`` (k=4, a
             noisy-head draft) token-exact against (b) in fewer ticks; (d)
             int8 weight-only serving at bf16 compute: bytes, prefill logits
             against bf16, every request served. Prints each engine's TTFT
             and latency p50/p99, decode-tick and prefill ms, tokens/s and
             acceptance beside the card's name and power limit.
3g. gateway — the same script through the port's ``Gateway`` (admission,
             weighted DRR across two tenants in two SLO classes, routing,
             spans, the queue-delay feedback sink) into a bf16 engine, as
             the Job ``gw`` under FeedbackPolicy + CudaBackend: (a) beside
             score and mm, (b) alone, in the order a, b, b, a. Checks
             nothing admitted is lost, exactly the two planned sheds, the
             engine's books against the gateway's, every payload against
             3s(a)'s direct engine (the near-tie rule), one gapless span
             chain per admitted request, the feedback loop boosting
             ``gw`` and shrinking its slice, and every launch of kernels
             2.1 and 2.4 on the tensor-core route.
             Prints per-class queue delay and latency, the engine's TTFT,
             the slice trajectory, the gateway's own host ms per tick, and
             the interactive latency co-located over alone (max and
             median, for each order).
3p. memory — HBM admission and the tenant lifecycle at flagship width,
             under a MemoryManager sized to the card (``for_device``: its
             total memory, the caching allocator's bytes in use) and a
             budget that holds the flagship training state once, not
             twice: a token corpus and a training image (``save_image``)
             on disk; ``train-a`` booted warm from it (``boot_job``,
             bitwise against the saved state) beside two (4, 1024) scorers
             that share one published bf16 copy of its weights
             (``WeightsRegistry``, charged once); ``train-a`` parked with a
             paging hook, paged to pinned host memory by the balloon when a
             second training tenant is admitted (the allocator's count falls
             by its bytes), paged back bitwise at wake (the same fixed-batch
             loss), trained on from a ``Prefetcher`` and checkpointed by an
             ``AsyncCheckpointer`` while its next step runs (restored
             bitwise). Every 2.1-2.3 launch on the tensor-core route. Prints
             page-out/in seconds and GB/s and the checkpoint's blocked
             time beside its write time; removes every file it wrote.
3e. moe    — the MoE family at the flagship's attention widths (4 experts
             of d_ff / 4, top-2): (a) ``moe-train`` booted cold from a "moe"
             image (capacity routing, full remat, attention through the
             flash kernels, (2, 1024) tokens, 3 steps) beside ``moe-serve``,
             the bf16 dropless engine on 3s's script, in one Partition
             under FeedbackPolicy + CudaBackend: steps, ledger TOKENS,
             finite losses, moved parameters, the drop fraction in [0, 1),
             every request served with ``mlp_extra_mean`` 0.0, and every
             2.1-2.3 launch on the tensor-core route, counted against
             layers x steps x (forward + recompute); (b) an fp32 dropless
             engine token-exact against the lockstep ``make_moe_generate``
             (3s's near-tie rule); (c) the speculative engine, MoE target
             and MoE noisy-head draft, exact against (b) in fewer ticks.
3c. control — the partition's control plane at flagship width: score, mm
             and a bf16 engine on 3s's script as Jobs, each run in a
             Partition of its own over CudaBackend: (a) credit2 on two
             lanes of the card in two runqueues under FeedbackPolicy;
             (b) SEDF, the engine holding a reservation (600 ms period,
             300 ms slice) and 3t's micro-stepped training tenant in
             extra time; (c) ARINC 653 in an explicit 100 ms major frame,
             every SCHED_PICK on the trace rings checked to lie in its
             tenant's own window and every overrun repaid from its own
             windows; (d) credit under the ATC policy, then under the
             tuned "serving" profile with a KnobChannel push that lowers
             the band mid-run (every later quantum inside it) and an
             inverted band refused whole; (e) an xsm denial and a
             required hook's veto that leave no HBM claim and no ledger
             slot, a wall watchdog that barks once at a 3 s hold of the
             card, a crash dump with the trace tail, and a read-only
             attach of the ledger file. Every launch of kernels 2.1-2.4
             in (a)-(c) counted and on the tensor-core route. Prints each
             scheduler's dump, device share against weight or window
             share, deadline misses and debts, and the engine's TTFT,
             latency and tick beside the card's name and power limit.
3r. record — record, replay and tune: 3c's tenants (3c's weights and
             cuts) in a credit Partition whose source is the host counter
             plane, ``HwCounterSource(inner=CudaBackend())``, steered by
             ``FeedbackPolicy.from_source``, with the run recorder on and a
             counter window sampled once a round: (a) checks one quantum
             record per dispatch (against the trace ring), one tick record
             per feedback decision, the recorded deltas summing to the
             ledger bit for bit and every 2.1/2.4 launch on the tensor-core
             route, and prints the counter ladder (absent events and why)
             and CudaBackend's own device time beside the overlaid one;
             (b) replays the trace offline under credit (every counter
             total reproduced), credit2 and SEDF (every step retired) and
             scores the window's sim-vs-real fidelity; (c) tunes the
             feedback policy by successive halving on a simulator workload
             built from the card's step times and stall fractions, writes
             the winner as a profile in a scratch directory and replays its
             check digest; (d) re-runs the tenants with the winner armed.
3n. native — the native runtime under the main path: (a) the port's C
             runtime and its fastcall module, built by g++ in phase 1 beside
             nvcc, and the tier they reach; (b) 3c's tenants and cuts under
             credit and FeedbackPolicy in a Partition with a file-backed
             ledger and rings, the engine's latency histograms fed through a
             HistBatch each tick: every ledger, ring and histogram on a
             native tier, every step retired and request served, the ledger
             words the counters; prints quanta, wall, ledger device time
             and the host time per quantum (wall minus device time, over
             quanta), the 2.1/2.4 launches by route and the runtime calls
             per quantum; (c) a monitor process attached to the ledger file
             and a file-backed Doorbell fed by the bus bridge (an overflow
             sample on the engine's TOKENS, rearmed at each virq): no
             snapshot tears, its final sums are the ledger's, its doorbell
             counts are the virqs the bus raised and delivered; (d) ns per
             op of those calls on the Python, ctypes and fastcall tiers on
             the card host's CPU (best of rounds after a warm one), and
             each tier's cost of one quantum's calls; (e) the five tuned
             profiles' check digests on the native sim core, and 3r's
             recorded workload under credit on the Python and native
             tiers, reports and digests identical, with simulated seconds
             per wall second; (f) 3p's corpus and loader through
             ``pbst_gather_rows``, every batch's bytes against the numpy
             gather. Every earlier phase's partitions (and 3g's gateway)
             are checked to run on the native tiers too.
3j. journal — durability and federation at flagship width: (a) 3g's 24
             requests (8 at tick 0, then one a tick) through a Gateway with
             the write-ahead journal at the registry's defaults, over a
             bf16 engine; a ProcessKill through the fault plan at a seeded
             tick (with completions, queued and in-flight requests); the
             gateway, engine, KV cache and weights dropped; the weights
             rebuilt from their seed, a fresh engine, ``recover_gateway``
             from the journal file alone with the client's prompts resent
             by rid. Checks every admitted rid completes exactly once
             across both generations, no done rid is dispatched again,
             the in-flight set is requeued, new rids carry ``-r1-``, and
             the recovered digest equals an independent replay of the file
             as the kill left it; compares tokens with an uninterrupted
             journaled run. Prints journal bytes, records, commits and
             fsyncs, host us per commit, the time to recover split into
             its parts, and TTFT/latency of the requests that straddle the
             crash beside the uninterrupted run's. (b) three
             FederatedGateway members over three engines on one copy of
             the weights: a canary-scoped knob push adopted by exactly its
             member (its backend re-rated by ``apply_member_knobs``), the
             busiest member's death (its requests handed off), a drain and
             a rejoin, then a crash of the whole process recovered by
             ``recover_federation``; checks exactly-once completion and
             every lease identity (minted under burst + rate x time).
             (c) ``run_gateway_chaos`` and ``run_federation_chaos`` with
             the stock crash plan at the reference tests' seeds, held to
             their golden digests.
3d. cluster — the cluster control plane at flagship width, in this
             process on 127.0.0.1 with an auth token: two agents, each a
             credit Partition over CudaBackend with a FeedbackPolicy,
             behind one Controller. (a) ``train``, booted by the agents'
             ``"image"`` workload from a warm flagship training image, and
             ``mm``, phase 3's matmul tenant, placed on different agents
             and driven in controller rounds; the telemetry op's counters
             against each partition's ledger, word for word; the first
             loss finite. (b) ``migrate_job`` of ``train``: sched_count,
             micro_progress, counters and steps carried exactly, no
             job-sleep hook for the quiesce, the restored state the
             image's (device state is not carried: the job re-boots), then
             a pause over RPC, a page-out (``list_jobs`` shows "paged"), a
             Remus ``snapshot_record`` that leaves it paged with HBM in use
             unchanged, and an unpause that pages it back bitwise. (c)
             Remus replication to the other agent until 2 epochs are
             acked, the holder killed (its jobs dropped, their HBM freed),
             heartbeats to its death, ``recover()`` restoring ``train``
             from the replica at no fewer steps than the last acked epoch
             and running it to max_steps; a Controller rebuilt by
             ``load_state`` from the Store saved before the kill holds the
             same job map. (d) on the card host's CPU: the process
             federation (three member processes, one SIGKILLed and
             restarted from its journal, every invariant), two disarmed
             runs against the digest the reference gives, and the agent
             chaos harness's smoke scenario against the reference's golden
             digest. Prints RPC ping p50/p99 and a 16-entry multicall, the
             migration's parts, the Remus epoch capture and record size,
             kill to the recovered job's next step, member spawn and
             SIGKILL-to-recovered times, and 2.1-2.4's launches.
3a. autopilot — the closed tuning loop at flagship width: (a) three
             FederatedGateway members, each a Gateway over its own bf16
             engine on one copy of 3s's weights, 3j's script twice over to
             six tenants on a virtual clock, an Autopilot at the reference
             harness's cadence: the recorder's window saved and loaded
             keeps its digest, the shadow search on it reproduces the
             loop's proposal, only the canary's knobs move in the guard,
             every member ends on what the decision says, admitted ==
             completed, tokens against 3s's engine alone; (b)
             ``run_autopilot_demo``'s loop, with and without the injected
             pathological candidate, beside a card Partition of score
             (2.1) and mm (2.4) under credit and a FeedbackPolicy whose
             KnobWatcher is keyed as the canary member and which runs a
             fixed number of quanta after each federation tick: the
             report equals ``run_autopilot_demo``'s byte for byte, the
             partition adopts what the canary member adopts at the same
             generations (the 10 us band at the canary's, the reference
             at the rollback's); per band: quanta, mm steps a quantum,
             host ms a quantum against ``autopilot.switch_cost_ns``, the
             device shares; (c) ``run_federation_chaos(autopilot=True)``
             and the plain run at the reference tests' goldens; (d) the
             demo hunt on one and two spawn workers at one digest, the
             port's corpus replayed at its golden digests, a what-if per
             entry, a spawn worker's start cost (no torch in it).
3k. check — the static checker on the card host: (a) phase 3's score
             (2.1) and mm (2.4) tenants as jobs of one agent on 127.0.0.1
             (credit, a FeedbackPolicy over CudaBackend, each tenant's
             working set claimed through a MemoryManager), created and run
             to their max_steps through an RpcClient, with the ``lockdep``
             boot param set and every ``ProfiledLock`` acquisition fed to
             lockdep; the graph exported, no violation; (b) ``pbst-torch
             check --format json --lockdep-graph`` over the port's tree in
             a child process: exit 0, no finding, exactly the four
             justified suppressions, every pass, and no torch, JAX or
             ``pbs_tpu`` imported; (c) a static lock edge the checker
             records (the port's tree has none, so the port-named clean
             fixture tree's) checked with (a)'s graph alone (exit 0) and
             with its reverse added (exactly one ``lock-order`` finding at
             the edge's line, exit 1). Prints the classes, edges, files
             scanned and wall seconds.
3f. observe — the foreign tenants and their observers: (a) three
             callables that follow no protocol, adopted through
             ``Job.foreign`` (``profile_every=1``) into one credit
             Partition on ``CudaBackend(profile_every=0)`` with a
             file-backed ledger and trace rings and a FeedbackPolicy:
             ``fscore`` (phase 3's scoring forward, 2.1 twelve times a
             step), ``fmm`` (six chained bf16 ``torch.mm`` at 4096^2) and
             ``few`` (40 tanh-scale-shift passes over 256 MiB fp32); every
             tenant retires its steps, each cost harvested by one counted
             invocation (``job.compiled``), fmm's DEVICE_FLOPS per step
             6 x 2 x 4096^3 within 1%, few's measured stall fraction at
             least 0.2 over fmm's, few's slice grown and fmm's shrunk, 2.1
             launched 12 x (steps + 1) times, all "wgmma"; (b) meanwhile a
             child process that imports no torch runs ``pbst-torch
             oprofile`` on the ledger (a row per tenant, no sample lost,
             device ms within 10% of the partition's over the window) and
             then ``pbst-torch mon`` on the rings (the three jobs with
             nonzero execs); (c) the phase's obs dump through ``perfc``,
             ``lockprof``, ``params`` and ``lockdep --dump-graph`` into
             ``check --lockdep-graph``: the clean fixture clean with the
             live graph, and exactly one ``lock-order`` finding once the
             fixture's edge, taken live in reverse, is dumped (3k (c)'s
             verdicts); (d) ``pbst-torch selftest`` on every tier, ``perf
             --json`` in python and native mode at full and quick op
             counts recorded as a stamped baseline (``--baseline-out
             PATH`` keeps it), ``perf --check --quick`` against it, each
             bench's ns/op printed beside 3n(d)'s tier costs.
3x. parallel — the parallel schedules (``pbs_tpu_torch.parallel``) on
             two rank processes that share the card, their exchanges
             over gloo staged through pinned host memory: (a) the
             flagship (bf16, remat "dots", flash attention) takes two
             AdamW steps on seeded (2, 1024) tokens in this process, at
             full depth and at the reduced depth of (b)'s other
             schedules, and the MoE family likewise; (b) the sp2 ring
             with flash blocks at full width and depth, sp2 Ulysses, tp2
             with sequence parallelism, pp2 over 2 microbatches and MoE
             ep2 at 3e's widths, each holding (a)'s two losses within
             5e-3 x max(1, |loss|) on both ranks, and the ring's every
             launch of 2.1-2.3 on the tensor-core route; (c) a one-rank
             NCCL world training over {"dp": 1}. Prints per schedule and
             rank the ms per step, the kernels' launches by route, the
             bytes staged through the host per step and the peak device
             memory, beside the reckoned memory of a replica.
3v. serve  — the sharded serving tier (``pbs_tpu_torch.serve``) on 3s's
             script (8 slots, bucket 128, slabs of 512) behind the port's
             Gateway: (a) ``ShardedServeBackend`` at tp=1, dp=1 over
             phase 3's bf16 tree, each completion's tokens against 3s
             (a)'s direct engine (near-ties only), no bypass, one gapless
             span chain per request, ``gather_params()`` the tree passed
             in bit for bit, the 1x1 mesh; (b) ``DisaggServeBackend`` on
             the same script, 2 prefill lanes beside (a)'s 8 decode
             slots: no decode-pool prefill, a handoff per completion,
             tokens against (a)'s; (c) two rank processes
             sharing the card over gloo (exchanges staged through pinned
             host memory), each a virtual-clock gateway in front of
             ``ShardedServeBackend(tp=2)``: the dense bf16 engine at
             full depth, the int8 engine and the dropless MoE engine at
             3e's widths at 4 layers and the dense one in fp32 at 4; both
             ranks' completions and probe prefill logits identical, the
             logits within 0.25 std of one process's engine on the same
             weights, and the tokens against that engine's (fp32: near-
             ties only; bf16: divergences the measured logit difference
             can close); (d) ``pbst-torch serve stats``, ``serve demo`` and
             ``serve demo --disagg`` in child processes on the card.
             Prints TTFT p50/p99 and the decode tick of (a) and (b), and
             per (c) rank the decode tick, a prefill, the exchanges and
             bytes staged through the host a decode tick and the peak
             device memory.
3b. drivers — the root scripts' twins (``pbs_tpu_torch.drivers``, ``.examples``):
             (a) ``graft_entry.entry()``'s flagship forward on zero tokens
             (4, 256): logits (4, 256, 32768), finite; (b) the
             long-context training path through ``bench_longctx``'s
             ``measure_point`` (remat "dots", AdamW): the "pallas" column at
             (4096, 2) and (8192, 1) and the "xla" column at (4096, 2), 2
             steps a chunk, 1 warm and 1 timed chunk, the flash kernels
             launched 24 / 12 / 12 a step (forward and recompute, dq, dk/dv),
             all on the tensor cores, finite losses, the first step's loss
             of "pallas" at 4096 within LONGCTX_LOSS_REL of "xla"'s on the
             same params and tokens, peak memory per point; (c)
             ``bench_serving``'s prefill and decode rows and its
             ``continuous_bf16`` and ``continuous_moe_dropless`` engines;
             (d) ``graft_entry.dryrun_multichip(8)``: the eleven parallel
             schedules on eight gloo rank processes on the card host's CPU
             (or the budget's notice); (e) the three walkthroughs in child
             processes on the card, each rc 0, beside (d); (f) the
             headline bench's twin (``drivers.bench``): (f1) ``python -m
             pbs_tpu_torch.drivers.bench`` with no knob, as the driver
             runs it (batch 6, S 1024, 2 warm and 3 timed chunks of 10
             steps): its one JSON line without an error, tokens/s > 0, 0
             < mfu <= 1, a finite loss below the first step's, the
             flagship's n_params, the card's name; (f2) its worker body
             in this process with attn "pallas", 2.1-2.3 launched 24 / 12
             / 12 a step, all on the tensor cores, at the shape phase 2
             held them at (BENCH_FLASH_SHAPE); (f3) ``--serving-fallback``
             on the card, alone, every request completed; (f4) with no
             visible card the error row, rc 1 and no serving number, and
             a stub worker stalled past a 5 s deadline gone, with its
             child, when the supervisor returns. Prints its wall.
4. numerics — the scoring forward through the flash kernel against the dense
             attention path on the same weights, the KV-cache prefill
             against the full forward, one micro-batch's training loss
             and gradients through the flash kernels against the dense
             attention path, and the same for the MoE forward, loss and
             gradients in fp32, with the routing decisions that flipped
             between the two (a flip passes only at a near-tie).
5. times   — each kernel, its plain version and one PyTorch library call
             computing the same function, at the main paths' shapes (2.1 at
             the serving and at the training shape; 2.1-2.3 at 3b's
             long-context shapes (2, 4095) and (1, 8191)), with achieved TFLOP/s
             and the fraction of the bound each kernel reaches; 2.2 and 2.3
             also on their CUDA-core route and beside the row-delta
             reduction they read; one profiled training micro-step and
             one profiled MoE training step (device time by kernel, idle
             share).

``--trace-out PATH`` also writes one profiled quantum's Chrome trace,
trimmed to a few dozen events (the CPU tests parse such a trace from
``tests/data/``).

Prints the card's name and power limit, then one ``{"kernels": [...]}`` line,
then, last, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is available or the port cannot be imported.
Float32 products run in full fp32 here (TF32 off).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

FLAGSHIP = dict(vocab=32_768, d_model=2048, n_layers=12, n_heads=16,
                n_kv_heads=8, d_ff=5_632, max_seq=1024)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 128, 32
SCORE_BATCH, SCORE_SEQ = 4, 1024
MM_N, MM_BLOCK = 4096, 256
STEPS = {"serve": 4, "score": 6, "mm": 8}
# The training tenant: micro-batch (2, 1024), 3 micro-batches per AdamW
# step (a global batch of 6 x 1024), 2 steps.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS, TRAIN_LR = 2, 1024, 3, 2, 3e-4
# Phase 3m, measured telemetry: every tenant at width, each sampled by
# torch.profiler on its first invocation and every 2nd after it; fewer
# steps than phases 3 and 3t, and one slice for all to start from.
MEASURED_STEPS = {"serve": 3, "score": 4, "mm": 8}
MEASURED_TRAIN_STEPS = 2
MEASURED_PROFILE_EVERY = 2
MEASURED_TSLICE_US = 300
MEASURED_COMPILE_BUDGET_NS = 600 * 10 ** 9
# Phase 3s, the serving engine: a seeded script of 24 requests (prompts of
# 16-128 tokens, budgets of 8-64), 8 at tick 0 then 2 a tick, the last 4
# repeating the first 4 prompts; 8 slots, prompts padded to 128, slabs of
# 512 positions, a prefix cache of 32 entries.
ENGINE_SEED = 6
ENGINE_REQUESTS, ENGINE_FIRST, ENGINE_PER_TICK, ENGINE_REPEATS = 24, 8, 2, 4
ENGINE_PROMPT, ENGINE_NEW = (16, 128), (8, 64)
ENGINE_SLOTS, ENGINE_BUCKET, ENGINE_MAX_LEN, ENGINE_PREFIX = 8, 128, 512, 32
# The speculative engine's draft: the target with its head perturbed by
# seeded Gaussian noise at 5% of the head's standard deviation, k = 4.
ENGINE_K, ENGINE_DRAFT_NOISE = 4, 0.05
# A greedy divergence passes only at a near-tie: the lockstep run's top-2
# fp32 logits within 1e-4 of the larger one's magnitude.
ENGINE_TIE = 1e-4
# int8 weight-only: under 0.55 x the bf16 tree's bytes, and prefill logits
# within 0.35 std of the bf16 tree's (the bound of tests/test_quant.py).
ENGINE_INT8_BYTES, ENGINE_INT8_LOGITS = 0.55, 0.35
# The int8 engine's own prefill logits against the lockstep prefill's on
# the same int8 tree, in std of the latter: two bf16 paths, one function
# (a sound H100 run read 0.0000 to four places; a wrong scale or slice in
# the engine's int8 path moves the logits by ~1 std).
ENGINE_INT8_PATHS = 0.02
# Decode ticks of the bf16 engine profiled after (a), all slots busy.
ENGINE_PROFILED_TICKS = 3
# Phase 3g, the gateway front door: 3s's script through the port's
# Gateway into a bf16 engine with 3s's settings. Tenant "chat"
# (interactive, twice bulk's fair-queue weight) gets the requests with a
# budget of GW_CHAT_MAX_NEW or less, "bulk" (batch) the rest, and a
# request costs its token budget. Buckets hold more than the whole
# script's tokens, so none of the 24 is shed; the two planned sheds are
# an extra chat request costing more than the burst and a second copy
# of request 0 from "probe", whose queue holds one request.
GW_CHAT_MAX_NEW = 32
GW_WEIGHTS = {"chat": 512, "bulk": 256, "probe": 256}
GW_RATE, GW_BURST, GW_MAX_QUEUED = 4096.0, 2048.0, 32
# The gateway Job's first slice: a shrink cuts a slice to a third (or by
# 200 us), which the 100 us floor would hide.
GW_TSLICE_US = 600
GW_TRACE_CAPACITY = 1 << 16
# Phase 3p, memory admission and the tenant lifecycle: a corpus of 4M
# tokens from a numpy seed; the flagship training state (fp32 params and
# AdamW moments) booted from an image; two (4, 1024) scorers on one
# shared bf16 copy of its weights, 2 steps each; train-a 2 steps beside
# them, train-b 2 steps while train-a is paged out, then train-a 2 steps
# from the loader and 1 under an async checkpoint's write.
PAGING_SEED = 8
PAGING_CORPUS_TOKENS = 4_000_000
PAGING_SCORE_STEPS, PAGING_TRAIN_STEPS, PAGING_B_STEPS = 2, 2, 2
PAGING_AFTER_STEPS = 2
# Phase 3e, the MoE family: the flagship's attention widths with 4 experts
# of d_ff / 4 = 1408, top-2 (bench_serving.py's MoE rows, 700.6M
# parameters in all). moe-train: the reference's capacity routing
# (factor 1.25, groups of 4096: the 2 x 1023 routed tokens make one group
# of capacity 1279), bf16 on fp32 masters, full remat, attention through
# the flash kernels, (2, 1024) tokens, booted cold from a "moe" image.
# moe-serve: dropless, 3s's script and settings.
MOE = dict(FLAGSHIP, d_ff=FLAGSHIP["d_ff"] // 4, n_experts=4, top_k=2)
MOE_SEED, MOE_TRAIN_STEPS = 9, 3
# Phase 3x, the parallel schedules: two AdamW steps of each schedule on
# seeded (2, 1024) tokens from one seed's weights, the ring at the
# flagship's full depth, the others at PARALLEL_DEPTH layers; a
# schedule's losses within PARALLEL_TOL x max(1, |loss|) of the
# single-process run's (dryrun_multichip's contract); a rank that has
# not answered within PARALLEL_RANK_TIMEOUT_S fails the phase.
PARALLEL_SEED, PARALLEL_STEPS, PARALLEL_DEPTH = 11, 2, 4
PARALLEL_TOL = 5e-3
# The first step's summed gradients, per layer of each stacked leaf (one
# norm for the others), against the single-process run's at relative
# PARALLEL_GRAD_TOL: a gradient summed n times over an axis, or any
# scale of a leaf, is off by 0.5 or more, while AdamW's first step
# (elementwise g / (|g| + eps)) and so the losses would not show it. On
# an H100 the bf16 schedules came within 8.7e-4 (the ring's, 12
# layers); 1e-2 keeps room for other seeds.
PARALLEL_GRAD_TOL = 1e-2
PARALLEL_RANK_TIMEOUT_S = 600
# Phase 3x's flash calls (B, S, H, Hkv, hd, dtype, causal), held against
# the plain versions in phase 2: the sp2 ring's (2, 512) chunks, its
# diagonal block causal and its full blocks not; Ulysses' and tp2's full
# sequence on 8 of the 16 query heads; pp2's microbatch of one row.
PARALLEL_FLASH_SHAPES = (
    (TRAIN_BATCH, TRAIN_SEQ // 2, 16, 8, 128, "bfloat16", True),
    (TRAIN_BATCH, TRAIN_SEQ // 2, 16, 8, 128, "bfloat16", False),
    (TRAIN_BATCH, TRAIN_SEQ, 8, 4, 128, "bfloat16", True),
    (1, TRAIN_SEQ - 1, 16, 8, 128, "bfloat16", True),
)
# The long-context training path's flash calls (S - 1 after the shift),
# held to the plain versions in phase 2 and timed in phase 5: the
# flagship's heads at (2, 4095) and (1, 8191), bf16, causal.
LONGCTX_FLASH_SHAPES = ((2, 4095, 16, 8, 128), (1, 8191, 16, 8, 128))
# The headline bench's flash call (phase 3b (f2): drivers.bench's BATCH
# x SEQ - 1 at the flagship's heads), held to the plain versions in
# phase 2 as the long-context shapes are.
BENCH_FLASH_SHAPE = (6, 1023, 16, 8, 128)
# Phase 3b, the root scripts' twins. (b)'s long-context points (seq, batch,
# attn), each LONGCTX_STEPS steps a chunk, one warm and one timed chunk;
# the first step's loss of "pallas" within LONGCTX_LOSS_REL of "xla"'s
# at the same length (check_train_numerics' bound for the same pair at
# S = 1024). (d) runs under DRYRUN_BUDGET_S; (e)'s children each get
# EXAMPLE_TIMEOUT_S.
LONGCTX_POINTS = ((4096, 2, "pallas"), (4096, 2, "xla"), (8192, 1, "pallas"))
LONGCTX_STEPS, LONGCTX_LOSS_REL = 2, 1e-2
DRYRUN_BUDGET_S, EXAMPLE_TIMEOUT_S = 90, 300
EXAMPLES = ("train_from_text", "serving_stack", "multi_tenant")
# (f): the headline bench's children get BENCH_CHILD_TIMEOUT_S each; (f4)'s
# stub stalls past a BENCH_STALL_DEADLINE_S deadline.
BENCH_CHILD_TIMEOUT_S, BENCH_STALL_DEADLINE_S = 600, 5
# Phase 3v, the serving tier: 3s's script (8 slots, bucket 128, slabs of
# 512) through serve backends behind the port's gateway; (c)'s tp2
# engines from SERVE_SEED's weights, the dense one at the flagship's
# depth, the int8 and MoE ones at PARALLEL_DEPTH; (d)'s demos with
# SERVE_DEMO_REQUESTS requests, each child given SERVE_CHILD_TIMEOUT_S.
SERVE_SEED, SERVE_DEMO_REQUESTS, SERVE_CHILD_TIMEOUT_S = 17, 8, 300
# (b)'s prefill lanes, beside as many decode slots as (a) has: the
# decode tick then has (a)'s shapes, so the two compute alike and their
# tokens hold under ENGINE_TIE (bf16 products of another batch size
# round otherwise).
SERVE_PREFILL_LANES = 2
# (c)'s tp2 engines against one process's on the same weights. Each
# rank's prefill logits of the script's first SERVE_PROBES prompts
# within SERVE_TP_LOGITS x std of one process's (the row-parallel
# all-reduces left out, the host twin's fp32 logits moved by 3.1 std;
# on an H100 the bf16 engines came within 0.074, the MoE one within
# 0.14). Tokens: an fp32 engine under ENGINE_TIE, as 3s (b). A
# bf16 one rounds each row-parallel half-sum to bf16 before the
# all-reduce adds them, once more than one GEMM rounds the whole sum,
# and its logits resolve 2^-8 of their magnitude: it passes a
# divergence where the lockstep top-2 gap is under what the measured
# logit difference can close, twice the probes' max|diff| over their
# smallest top logit (:func:`tp_tie`).
SERVE_PROBES, SERVE_TP_LOGITS = 4, 0.25
# A routing decision (a token's top-2 experts in a layer) that differs
# between two fp32 runs passes only at a near-tie: the reference run's
# 2nd and 3rd router probabilities within MOE_ROUTE_TIE of each other.
MOE_ROUTE_TIE = 1e-4
# Phase 3c, the partition's control plane: score, mm and a bf16 engine on
# 3s's script, with 3s's weights, under the other schedulers, each run in
# a Partition of its own. (b) SEDF: a training micro-step takes 134-261 ms
# on the card (PERF.md section 5) and cannot be preempted, so the
# engine's period is more than twice the longest; its slice is half the
# period. One AdamW step (3 micro-steps) of 3t's training tenant runs in
# extra time.
CONTROL_WEIGHTS = {"score": 256, "mm": 512, "engine": 256}
CONTROL_SEDF_PERIOD_US, CONTROL_SEDF_SLICE_US = 600_000, 300_000
CONTROL_SEDF_LATENCY_US = 100_000
CONTROL_TRAIN_STEPS = 1
# (c) ARINC 653's major frame of 100 ms, sized from PERF.md section 5: the
# engine's 60 ms hold two to three decode ticks of 18-25 ms, score's 25 ms
# one step of 16-20 ms, mm's 5 ms its steps of 0.4-0.6 ms, then 10 ms
# idle. A SCHED_PICK record is written some microseconds after its
# decision; a pick counts as inside its window when it is at most
# CONTROL_PICK_SLACK_NS past the window's end.
CONTROL_FRAME = [("engine", 60_000), ("score", 25_000), ("mm", 5_000),
                 (None, 10_000)]
CONTROL_PICK_SLACK_NS = 200_000
# (d) the live push: the "serving" profile's cap (700 us) down to 300 us,
# 300 ms into the run.
CONTROL_PUSH_MAX_US, CONTROL_PUSH_AFTER_NS = 300, 300_000_000
# (e) the wall watchdog's timeout, and how long one step holds the card.
CONTROL_WATCHDOG_S, CONTROL_HOLD_S = 1.0, 3.0
# Phase 3r, record, replay and tune: 3c's tenants with 3c's weights and
# cuts, recorded live under credit; the simulator workload built from
# their recorded step times (registered for the phase only, never
# checked in), its tenants' step times jittered as the catalog's are.
RECORD_WORKLOAD = "card-3r"
RECORD_JITTER = 0.05
# A live run stops after this many scheduling rounds (it drains in a few
# hundred); the counter window keeps this many samples.
RECORD_MAX_ROUNDS = 100_000
RECORD_WINDOW_CAPACITY = 1 << 16
# Phase 3j, durability and federation. (a) 3g's 24 requests, 8 at tick 0
# then one a tick, through a journaled Gateway; the kill lands at the top
# of a tick drawn from JOURNAL_KILL_WINDOW by JOURNAL_SEED (the first
# completion comes at tick 10 or 11, the last arrival at tick 16), and
# the weights are rebuilt from JOURNAL_SEED.
JOURNAL_SEED = 13
JOURNAL_KILL_WINDOW = (12, 15)
# (b) (a)'s script through three members, each over its own engine, to
# six tenants (even ones interactive) on a virtual clock of 1 ms ticks;
# the serving profile model armed at a 50 us switch cost; a push of the
# band (100, 500) us scoped to one member at tick 2; a member death at
# tick 4, a drain at 6, a rejoin at 8 and the whole process killed at
# the top of tick 13.
FED_MEMBERS, FED_TENANTS, FED_TICK_NS = 3, 6, 1_000_000
FED_SWITCH_COST_NS, FED_CANARY_MAX_US = 50_000, 500
FED_PUSH_TICK, FED_KILL_TICK, FED_DRAIN_TICK = 2, 4, 6
FED_REJOIN_TICK, FED_CRASH_TICK = 8, 13
# (c) the reference tests' golden digests: tests/test_gateway_chaos.py
# (mixed, seed 0, 3 backends, 4 tenants, 160 ticks) and
# tests/test_crash_chaos.py (mixed, seed 0, 3 gateways, 4 tenants, 240
# ticks, stock_crash_plan(240)).
GOLDEN_GATEWAY_DIGEST = (
    "4ef79af3bcb1dcf7b03cad1cd27a91b61f6560f6ea6db0085e504bb08eff5737")
GOLDEN_CRASH_TRACE_DIGEST = (
    "538bba5c03c74c32f2eb43cf46374365f2b445fafc4b704044f4619979e50902")
GOLDEN_CRASH_REPORT_DIGEST = (
    "b65386f357c404918ba70d0db47bf864a060d9d0ac32817f3a6d36d36e6a5782")
# Phase 3d, the cluster control plane: two agents on 127.0.0.1 behind one
# Controller; train (3p's warm image, 4 steps) and mm (8 steps); pings
# and one multicall; Remus every 0.25 s until 2 epochs are acked.
CLUSTER_TRAIN_STEPS, CLUSTER_MM_STEPS = 4, 8
CLUSTER_PINGS, CLUSTER_MULTICALL = 200, 16
CLUSTER_REMUS_PERIOD_S, CLUSTER_EPOCHS, CLUSTER_EPOCH_WAIT_S = 0.25, 2, 30.0
CLUSTER_ROUND_LIMIT = 64
# (d) the process federation: three members, the stock kill plan; two
# disarmed runs against the digest the reference gives for the same
# arguments (tests/test_torch_procfed.py); and the reference's
# tests/test_chaos_smoke.py golden (stable, seed 0, 2 agents, 2 tenants,
# 2 rounds under FaultPlan.chaos(0)).
PROCFED_KILL_KW = dict(workload="mixed", seed=3, n_gateways=3, n_tenants=3,
                       ticks=120)
PROCFED_DISARMED_KW = dict(workload="mixed", seed=5, n_gateways=3,
                           n_tenants=3, ticks=60)
PROCFED_DISARMED_DIGEST = (
    "8604ac22cae1c8ee43b4ffea5b7030e5ba35501b70894d50a74c7f2504880fc2")
GOLDEN_SMOKE_DIGEST = (
    "d809f6d4bd0db30cea84f3b85eca3145f99c657f8f587e20915c34581528bbb1")
# Phase 3a, the closed tuning loop. (a) 3j's 24 requests AP_REPEATS
# times over (8 at tick 0, then one a tick) to six tenants, a chat budget
# (<= GW_CHAT_MAX_NEW) to an even, interactive tenant and a bulk one to
# an odd, batch tenant; three members over engines sharing one copy of
# 3s's weights, 4 ms virtual ticks (so that the 13-tick guard, a third
# of the arrival ticks, exceeds the 50 ms interactive target); an
# Autopilot at the reference harness's cadence (record a third of the
# arrival ticks, guard a third) and the registry's switch cost.
AP_REPEATS = 2
AP_TICK_NS = 4_000_000
# (b) run_autopilot_demo's loop (seed 0, 260 ticks, both values of
# pathological) with a card Partition beside it: 3c's score and mm
# tenants under credit and a FeedbackPolicy, AP_CARD_QUANTA quanta after
# each federation tick, its KnobWatcher keyed as the member the seeded
# demo picks for its canary.
AP_DEMO_SEED, AP_DEMO_TICKS = 0, 260
AP_CANARY_MEMBER = "gw0"
AP_CARD_QUANTA = 2
AP_CARD_WEIGHTS = {"score": 256, "mm": 512}
# (c) tests/test_autopilot_chaos.py's goldens (mixed, seed 0, 3 gateways,
# 4 tenants, 240 ticks, autopilot=True) and tests/test_federation_chaos.py's
# plain goldens for the same run without the loop.
AP_CHAOS_KW = dict(workload="mixed", seed=0, n_gateways=3, n_tenants=4,
                   ticks=240)
GOLDEN_AP_TRACE_DIGEST = (
    "5b3e7d637df0babef9590c9d450de41384c04e8f908298f874452b3a74b223c7")
GOLDEN_AP_REPORT_DIGEST = (
    "bff117e15037e45b2aebaf7cf19448fd1fa84ff8f3c15cbab49898c2db1552fe")
GOLDEN_FED_TRACE_DIGEST = (
    "71a188673b85cf80a67a721b247443d22e3776a09ad491fc6a5356553218d6de")
GOLDEN_FED_REPORT_DIGEST = (
    "1ba265a705067e8d8761aaa8d57c23b30e38c25839b29c9f1debf380b5667242")
# (d) the archive digest of hunt(HuntConfig.demo()) (the reference's, on
# any worker count).
AP_HUNT_DIGEST = (
    "fc022d121c81c49b235b5e61ec63d8d2c109ea5991afde0f0d03bb92f6033786")
# Phase 3k, the static checker on the card host. (a) phase 3's score and
# mm tenants (CHECK_STEPS, weights CHECK_WEIGHTS) on one agent on
# 127.0.0.1, a credit Partition with a FeedbackPolicy over CudaBackend and
# a MemoryManager, created and driven in one-round ``run`` calls through an
# RpcClient (at most CHECK_ROUND_LIMIT), every named lock fed to lockdep;
# (b) ``pbst-torch check`` over the port's tree with (a)'s graph, in a
# child process with no deadline but CHECK_CHILD_TIMEOUT_S; (c) the
# reverse of one static lock edge added to (a)'s graph.
CHECK_STEPS = {"score": 6, "mm": 8}
CHECK_WEIGHTS = {"score": 256, "mm": 512}
CHECK_ROUND_LIMIT = 64
CHECK_CHILD_TIMEOUT_S = 300
# The checker's verdict on the port's tree: no finding, and its justified
# suppressions in path order: the serving walkthrough's three direct
# engine submits (``examples/serving_stack.py``; the reference's copy lies
# outside its package's scan), then the four the reference's own tree
# carries.
CHECK_SUPPRESSED = ("gw-direct-submit",) * 3 + (
    "rollout-push", "perf-dispatch-alloc", "perf-dispatch-alloc",
    "perf-emit-in-loop")
# Phase 3f, the foreign tenants and their observers: three tenants adopted
# through Job.foreign (profile_every=1, a first slice of OBSERVER_TSLICE_US)
# in one credit Partition under a FeedbackPolicy ticking every round:
# phase 3's scoring forward (OBSERVER_STEPS["fscore"] steps), a chain of
# OBSERVER_MM_CHAIN bf16 torch.mm at MM_N^2, and OBSERVER_EW_PASSES
# tanh-scale-shift passes over OBSERVER_EW_NUMEL fp32 (256 MiB). Each has
# at least the feedback window's 5 ticks past its first step. The observer
# child samples the ledger every OBSERVER_PERIOD_MS under the passive
# domain name OBSERVER_NAME (OBSERVER_DEADLINE_S is only its deadline:
# the parent ends it by closing its stdin), starts sampling within
# OBSERVER_PRIME_S of saying "ready", then draws OBSERVER_MON_ITERATIONS
# mon frames.
OBSERVER_TSLICE_US = 500
OBSERVER_STEPS = {"fscore": 6, "fmm": 16, "few": 8}
OBSERVER_MM_CHAIN, OBSERVER_EW_PASSES = 6, 40
OBSERVER_EW_NUMEL = 64 * 2 ** 20
OBSERVER_NAME = "card"
OBSERVER_PERIOD_MS, OBSERVER_DEADLINE_S, OBSERVER_PRIME_S = 20, 120, 0.3
OBSERVER_MON_ITERATIONS = 2
# torch.profiler on the card host loses device records at a session's
# head (1-19, on the pads) and a few elsewhere (3-67 of ~4,400 launches
# in three runs of this phase): a measured fraction is trusted while at
# most this share of the quanta's own records is missing.
OBSERVER_LOST_SHARE = 0.02
H100_PEAK_BF16_FLOPS = 989e12  # dense, data sheet
H100_PEAK_HBM_BW = 3.35e12

KERNELS = {
    "flash_fwd": dict(source="pbs_tpu_torch/ops/csrc/flash_fwd.cu",
                      replaces="pbs_tpu/ops/attention.py:70"),
    "flash_bwd_dq": dict(source="pbs_tpu_torch/ops/csrc/flash_bwd.cu",
                         replaces="pbs_tpu/ops/attention.py:164"),
    "flash_bwd_dkv": dict(source="pbs_tpu_torch/ops/csrc/flash_bwd.cu",
                          replaces="pbs_tpu/ops/attention.py:209"),
    "instrumented_matmul": dict(
        source="pbs_tpu_torch/ops/csrc/instrumented_matmul.cu",
        replaces="pbs_tpu/ops/matmul.py:43"),
}


class Failed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise Failed(what)


def phase(name: str) -> None:
    print(f"\n== {name} ==", flush=True)


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    return max_abs(a, b) / (float(b.float().abs().max()) + 1e-9)


# The flash kernel computes in fp32 and rounds only its output, so it is
# held element by element against the plain version's fp32 result:
# |o - ref| <= FLASH_ATOL + r * |ref|, with r = 2^-8 (at most half a
# bf16 ulp) for a bf16 o and r = 0 for an fp32 o; lse within FLASH_ATOL.
FLASH_ATOL = 2e-4
BF16_HALF_ULP = 2.0 ** -8


def flash_against_plain(torch, q, k, v, causal, out_f32=False):
    """Run kernel 2.1 and its plain version (fp32 output) on q, k, v.
    Returns (ok, max abs err of o, max abs err of lse, the limit)."""
    from pbs_tpu_torch.ops.attention import (flash_attention_cuda,
                                             flash_attention_plain)

    o, lse = flash_attention_cuda(q, k, v, causal, out_f32=out_f32)
    ref, ref_lse = flash_attention_plain(q, k, v, causal, out_f32=True)
    r = BF16_HALF_ULP if o.dtype == torch.bfloat16 else 0.0
    diff = (o.float() - ref).abs()
    err_l = max_abs(lse, ref_lse)
    ok = (bool((diff <= FLASH_ATOL + r * ref.abs()).all())
          and bool(torch.isfinite(o).all()) and err_l <= FLASH_ATOL)
    return ok, float(diff.max()), err_l, f"{FLASH_ATOL:g} + {r:g}|ref|"


# The backward kernels also accumulate in fp32 and round once, so each
# gradient is held against the plain backward's fp32 result on the same
# inputs: |g - ref| <= BWD_REL[dtype] * max|ref| + r * |ref|, r = 2^-8
# for a bf16 gradient (half a bf16 ulp) and 0 for an fp32 one. Beside
# each check the smallest BWD_REL that would have passed is printed. On an
# H100 that was <= 1.7e-6 (bf16, where the 2^-8 term carries most of the
# rounding; the ring's full (2, 512) blocks) and <= 1.7e-6 (fp32,
# summation order over up to 2048 keys); at the long-context shapes bf16
# needed 2.0e-6 at (2, 4095) and 4.3e-6 at (1, 8191), whose gradient
# sums run over up to 8191 terms. 1e-5 keeps room for other
# seeds and is 100x tighter than a wrong kernel's error.
BWD_REL = {"bfloat16": 1e-5, "float32": 1e-5}


def bwd_against_plain(torch, gen, q, k, v, causal, with_dlse,
                      out_f32=None):
    """Run kernels 2.2 and 2.3 through the backward wrapper on q, k, v,
    the forward kernel's (o, lse) and a random do (and a random fp32 lse
    cotangent when ``with_dlse``), and the plain backward in fp32 on the
    same inputs. o and do are fp32 with ``out_f32`` (by default
    ``with_dlse``: the reference's ``flash_attention_lse``), else in the
    inputs' dtype (the ring's flash blocks: a bf16 do beside the fp32
    dlse). Returns (ok, max abs err, the smallest BWD_REL that passes,
    the limit, the routes of the dq and the dk/dv launch)."""
    from pbs_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_bwd_dkv_cuda,
                                             flash_attention_bwd_dq_cuda,
                                             flash_attention_bwd_plain,
                                             flash_attention_cuda)

    if out_f32 is None:
        out_f32 = with_dlse
    o, lse = flash_attention_cuda(q, k, v, causal, out_f32=out_f32)
    do = torch.randn(o.shape, device="cuda", generator=gen).to(o.dtype)
    dlse = (torch.randn(lse.shape, device="cuda", generator=gen)
            if with_dlse else None)
    wrappers = (flash_attention_bwd_dq_cuda, flash_attention_bwd_dkv_cuda)
    before = [dict(w.launches_by_route) for w in wrappers]
    got = flash_attention_bwd(q, k, v, o, lse, do, dlse, causal)
    routes = tuple(route_taken(w, b) for w, b in zip(wrappers, before))
    ref = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o, lse,
                                    do.float(), dlse, causal)
    ok, err, need = True, 0.0, 0.0
    name = str(q.dtype)[6:]
    r = BF16_HALF_ULP if q.dtype == torch.bfloat16 else 0.0
    for g, want in zip(got, ref):
        diff = (g.float() - want).abs()
        scale = float(want.abs().max())
        ok = (ok and g.dtype == q.dtype and bool(torch.isfinite(g).all())
              and bool((diff <= BWD_REL[name] * scale
                        + r * want.abs()).all()))
        err = max(err, float(diff.max()))
        need = max(need, float((diff - r * want.abs()).clamp_min(0).max())
                   / scale)
    return ok, err, need, f"{BWD_REL[name]:g} max|ref| + {r:g}|ref|", routes


def parallel_flash_shapes(torch) -> tuple:
    """:data:`PARALLEL_FLASH_SHAPES` with each dtype named by torch."""
    return tuple((*shape[:5], getattr(torch, shape[5]), shape[6])
                 for shape in PARALLEL_FLASH_SHAPES)


def route_taken(wrapper, before: dict) -> str:
    """The route of the one launch ``wrapper`` made since ``before`` (a
    copy of its ``launches_by_route``), or a description of what else
    happened."""
    grew = {k: n - before[k] for k, n in wrapper.launches_by_route.items()
            if n != before[k]}
    return next(iter(grew)) if list(grew.values()) == [1] else f"{grew}"


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_in_turns(torch, fns: dict, iters: int) -> dict:
    """Each callable timed twice, in the order A B C C B A; the mean."""
    order = list(fns) + list(reversed(fns))
    acc = {k: [] for k in fns}
    for k in order:
        acc[k].append(time_ms(torch, fns[k], iters))
    return {k: sum(v) / len(v) for k, v in acc.items()}


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / H100_PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / H100_PEAK_HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# -- phase 2 -----------------------------------------------------------------


def check_kernels(torch, gen) -> None:
    from pbs_tpu_torch.ops.attention import flash_attention_cuda
    from pbs_tpu_torch.ops.matmul import (instrumented_matmul_cuda,
                                          instrumented_matmul_plain,
                                          scale_stats)

    def qkv(B, S, H, Hkv, hd, dtype):
        return tuple(torch.randn(B, S, h, hd, device="cuda", generator=gen)
                     .to(dtype) for h in (H, Hkv, Hkv))

    for B, S, H, Hkv, hd, dtype, causal in (
            (2, 512, 8, 4, 128, torch.bfloat16, True),
            (2, 512, 8, 4, 128, torch.bfloat16, False),
            (2, 511, 8, 4, 128, torch.bfloat16, True),  # ragged S
            (1, 2048, 8, 4, 128, torch.bfloat16, True),
            (2, 384, 8, 2, 64, torch.float32, True),
            # the training path's call: S - 1 = 1023 after the shift
            (TRAIN_BATCH, TRAIN_SEQ - 1, 16, 8, 128, torch.bfloat16, True),
            *parallel_flash_shapes(torch),
            *((*shape, torch.bfloat16, True)
              for shape in (*LONGCTX_FLASH_SHAPES, BENCH_FLASH_SHAPE))):
        for out_f32 in (False, True):
            before = dict(flash_attention_cuda.launches_by_route)
            ok, err_o, err_l, limit = flash_against_plain(
                torch, *qkv(B, S, H, Hkv, hd, dtype), causal, out_f32)
            route = route_taken(flash_attention_cuda, before)
            want = "wgmma" if dtype == torch.bfloat16 else "simt"
            check(ok and route == want,
                  f"flash {str(dtype)[6:]} B{B} S{S} H{H}/{Hkv} hd{hd} "
                  f"causal={causal} out_f32={out_f32} [{route}]: |o-ref| "
                  f"max {err_o:.2e} <= {limit}, lse {err_l:.2e} <= "
                  f"{FLASH_ATOL:g}")

    for B, S, H, Hkv, hd, dtype, causal in (
            (2, 512, 8, 4, 128, torch.bfloat16, True),
            (2, 512, 8, 4, 128, torch.bfloat16, False),
            (2, 511, 8, 4, 128, torch.bfloat16, True),  # ragged S
            (1, 2048, 8, 4, 128, torch.bfloat16, True),
            (2, 130, 8, 4, 64, torch.bfloat16, True),
            (2, 17, 4, 2, 32, torch.bfloat16, False),
            (1, 200, 4, 4, 16, torch.bfloat16, True),
            (2, 384, 8, 2, 64, torch.float32, True),
            # the training path's call: S - 1 = 1023 after the shift
            (TRAIN_BATCH, TRAIN_SEQ - 1, 16, 8, 128, torch.bfloat16, True),
            *parallel_flash_shapes(torch),
            *((*shape, torch.bfloat16, True)
              for shape in (*LONGCTX_FLASH_SHAPES, BENCH_FLASH_SHAPE))):
        # (dlse, o and do fp32): no lse cotangent; the reference's lse
        # variant; the ring's flash blocks (bf16 o and do, fp32 dlse).
        # The long-context and headline shapes take the two tensor-core
        # variants (a bf16 do), the ones their training path launches
        # and the ring's.
        variants = (((False, False), (True, False))
                    if (B, S, H, Hkv, hd) in (*LONGCTX_FLASH_SHAPES,
                                              BENCH_FLASH_SHAPE) else
                    ((False, False), (True, True), (True, False)))
        for with_dlse, out_f32 in variants:
            ok, err, need, limit, routes = bwd_against_plain(
                torch, gen, *qkv(B, S, H, Hkv, hd, dtype), causal, with_dlse,
                out_f32)
            # an fp32 do takes the CUDA-core route
            want = ("wgmma" if dtype == torch.bfloat16 and not out_f32
                    else "simt")
            check(ok and routes == (want, want),
                  f"flash bwd {str(dtype)[6:]} B{B} S{S} H{H}/{Hkv} hd{hd} "
                  f"causal={causal} dlse={'rand' if with_dlse else 0} "
                  f"do {'fp32' if out_f32 else str(dtype)[6:]} "
                  f"[{'/'.join(routes)}]: dq/dk/dv |g-ref| max {err:.2e} <= "
                  f"{limit} (passes down to {need:.1e} max|ref|)")

    a = torch.randn(512, 512, device="cuda", generator=gen).bfloat16()
    b = torch.randn(512, 512, device="cuda", generator=gen).bfloat16()
    before = dict(instrumented_matmul_cuda.launches_by_route)
    out, raw = instrumented_matmul_cuda(a, b, 256, 256, 256)
    route = route_taken(instrumented_matmul_cuda, before)
    ref, ref_raw = instrumented_matmul_plain(a, b, 256, 256, 256)
    st = scale_stats(raw, 256, 256, 256)
    err = rel_err(out, ref)
    check(raw.tolist() == ref_raw.tolist() and st.mxu_tiles == 8
          and st.flops == 8 * 2 * 256 ** 3 and err < 1e-3
          and route == "wgmma",
          f"matmul bf16 512^3 [{route}]: stats {raw.tolist()} "
          f"== plain {ref_raw.tolist()}, mxu_tiles 8, rel err {err:.2e} "
          f"< 1e-3")
    # K = 12: rows of 24 bytes, which TMA cannot address
    a = torch.randn(64, 12, device="cuda", generator=gen).bfloat16()
    a[:4, :4] = 0
    b = torch.randn(12, 64, device="cuda", generator=gen).bfloat16()
    before = dict(instrumented_matmul_cuda.launches_by_route)
    out, raw = instrumented_matmul_cuda(a, b, 4, 4, 4)
    route = route_taken(instrumented_matmul_cuda, before)
    ref, ref_raw = instrumented_matmul_plain(a, b, 4, 4, 4)
    err = rel_err(out, ref)
    check(raw.tolist() == ref_raw.tolist() and err < 1e-3
          and route == "simt",
          f"matmul bf16 64x12x64 blocks 4 [{route}]: stats "
          f"{raw.tolist()} == plain {ref_raw.tolist()}, rel err {err:.2e} "
          f"< 1e-3")
    a, b = mm_operands(torch, gen)
    before = dict(instrumented_matmul_cuda.launches_by_route)
    out, raw = instrumented_matmul_cuda(a, b, MM_BLOCK, MM_BLOCK, MM_BLOCK)
    route = route_taken(instrumented_matmul_cuda, before)
    ref, ref_raw = instrumented_matmul_plain(a, b, MM_BLOCK, MM_BLOCK,
                                             MM_BLOCK)
    err = rel_err(out, ref)
    check(raw.tolist() == ref_raw.tolist() and raw.tolist()[1] > 0
          and err < 1e-3 and route == "wgmma",
          f"matmul bf16 4096^3 with planted zero tiles [{route}]: stats "
          f"{raw.tolist()} == plain {ref_raw.tolist()}, rel err "
          f"{err:.2e} < 1e-3")


def mm_operands(torch, gen):
    a = torch.randn(MM_N, MM_N, device="cuda", generator=gen).bfloat16()
    b = torch.randn(MM_N, MM_N, device="cuda", generator=gen).bfloat16()
    blk = MM_BLOCK
    for i, k in ((0, 0), (3, 5), (7, 15), (15, 2)):  # planted zero A tiles
        a[i * blk:(i + 1) * blk, k * blk:(k + 1) * blk] = 0
    return a, b


# -- phase 3 -----------------------------------------------------------------


def serving_tenant(torch, gen, cfg, params):
    """The KV-cache serving tenant: (step_fn, state), answering
    SERVE_BATCH prompts of SERVE_PROMPT tokens with SERVE_NEW greedy
    tokens a batch."""
    from pbs_tpu_torch.models import make_serve_step

    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            device="cuda", generator=gen)
    serve_step = make_serve_step(cfg, max_new_tokens=SERVE_NEW)

    def serve_fn(state):
        return serve_step(state, prompts)

    return serve_fn, (params, torch.Generator(device="cuda").manual_seed(1), 0)


def check_served(job, counters) -> None:
    tokens = int(job.contexts[0].counters[counters.TOKENS])
    check(job.state[2] == STEPS["serve"]
          and tokens == STEPS["serve"] * SERVE_BATCH * SERVE_NEW,
          f"serve: {job.state[2]} batches answered, {tokens} "
          f"tokens == {STEPS['serve']} x {SERVE_BATCH} x {SERVE_NEW}")


def print_tenants(jobs, counters) -> None:
    print(f"  {'tenant':<6} {'steps':>5} {'device_ms':>10} "
          f"{'stall_rate':>10} {'tslice_us':>9} {'sched':>5} {'yields':>6}")
    for name, job in jobs.items():
        ctx = job.contexts[0]
        print(f"  {name:<6} {job.steps_retired():>5} "
              f"{int(ctx.counters[counters.DEVICE_TIME_NS]) / 1e6:>10.2f} "
              f"{job.stall_rate:>10.1f} {job.params.tslice_us:>9} "
              f"{ctx.sched_count:>5} "
              f"{int(ctx.counters[counters.YIELDS]):>6}", flush=True)


def scoring_tenant(torch, gen, cfg, params):
    """The forward-scoring tenant: (SCORE_BATCH, SCORE_SEQ) tokens
    through the flash kernel; its answer is the next-token predictions."""
    from pbs_tpu_torch.models import forward

    score_tokens = torch.randint(0, cfg.vocab, (SCORE_BATCH, SCORE_SEQ),
                                 device="cuda", generator=gen)
    score_cfg = dataclasses.replace(cfg, attn_impl="pallas")

    @torch.no_grad()
    def score_fn(state):
        logits = forward(score_cfg, params, score_tokens)
        # the (B,) next-token predictions are the tenant's answer
        return logits[:, -1].argmax(dim=-1), {"tokens": score_tokens.numel()}

    return score_fn


def mm_tenant(torch, gen):
    """The instrumented-matmul tenant on MM_N^3 bf16 with planted zero
    tiles: its in-kernel counters are its FLOP and byte metrics."""
    from pbs_tpu_torch.ops.matmul import instrumented_matmul, scale_stats

    a, b = mm_operands(torch, gen)

    def mm_fn(state):
        out, raw = instrumented_matmul(a, b, MM_BLOCK, MM_BLOCK, MM_BLOCK)
        return out, scale_stats(raw, MM_BLOCK, MM_BLOCK, MM_BLOCK).metrics()

    return mm_fn


def run_main_path(torch, gen, cfg, params):
    from pbs_tpu_torch.ops.attention import flash_attention_cuda
    from pbs_tpu_torch.ops.matmul import instrumented_matmul_cuda
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    serve_fn, serve_state = serving_tenant(torch, gen, cfg, params)
    score_fn = scoring_tenant(torch, gen, cfg, params)
    mm_fn = mm_tenant(torch, gen)

    # Warm each tenant once outside the partition (cuBLAS handles, the
    # caching allocator), so a slow first step is not charged as
    # device time.
    for fn, st in ((serve_fn, serve_state), (score_fn, None), (mm_fn, None)):
        fn(st)
    torch.cuda.synchronize()

    be = CudaBackend()
    part = Partition("smoke", source=be)
    check_native(part)
    fb = FeedbackPolicy(part)
    jobs = {
        "serve": Job("serve", step_fn=serve_fn, state=serve_state,
                     params=SchedParams(weight=256, tslice_us=100,
                                        boost_on_wake=True),
                     max_steps=STEPS["serve"]),
        "score": Job("score", step_fn=score_fn, state=None,
                     params=SchedParams(weight=256),
                     max_steps=STEPS["score"]),
        "mm": Job("mm", step_fn=mm_fn, state=None,
                  params=SchedParams(weight=512), max_steps=STEPS["mm"]),
    }
    for job in jobs.values():
        part.add_job(job)
    wrappers = {"flash_fwd": flash_attention_cuda,
                "instrumented_matmul": instrumented_matmul_cuda}
    reset_counts(wrappers.values())
    t0 = time.monotonic()
    quanta = part.run()
    wall = time.monotonic() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    routes = {k: dict(w.launches_by_route) for k, w in wrappers.items()}
    print(f"  {quanta} quanta in {wall:.2f} s wall; kernel launches "
          f"{launches}, by route {routes}", flush=True)
    print_tenants(jobs, Counter)
    print(f"  feedback: {json.dumps(fb.dump())}")

    for name, job in jobs.items():
        check(job.error is None and job.steps_retired() == STEPS[name],
              f"{name}: {job.steps_retired()} steps retired, no fault "
              f"({job.error})")
        ctx = job.contexts[0]
        snap = part.ledger.snapshot(ctx.ledger_slot)
        check(snap.tolist() == ctx.counters.tolist(),
              f"{name}: ledger snapshot equals the context counters")
        check(fb.min_us <= job.params.tslice_us <= fb.max_us,
              f"{name}: tslice {job.params.tslice_us} us inside the "
              f"feedback band [{fb.min_us}, {fb.max_us}]")
    mm_flops = int(jobs["mm"].contexts[0].counters[Counter.DEVICE_FLOPS])
    check(mm_flops == STEPS["mm"] * 2 * MM_N ** 3,
          f"mm: ledger DEVICE_FLOPS {mm_flops} == steps x 2 x 4096^3")
    check_served(jobs["serve"], Counter)
    pred = jobs["score"].state
    check(pred.shape == (SCORE_BATCH,) and bool(((pred >= 0)
                                                 & (pred < cfg.vocab)).all()),
          f"score: next-token predictions {pred.tolist()} in [0, vocab)")
    for name, n in launches.items():
        check(n > 0, f"{name}: {n} launches on the main path")
        check(routes[name] == {"wgmma": n, "simt": 0},
              f"{name}: every launch on the tensor-core route "
              f"({routes[name]})")
    serve_ctx = jobs["serve"].contexts[0]
    serve_ms_per_token = (int(serve_ctx.counters[Counter.DEVICE_TIME_NS])
                          / 1e6 / int(serve_ctx.counters[Counter.TOKENS]))
    return launches, routes, serve_ms_per_token


# -- phase 3t ----------------------------------------------------------------


def train_config(torch):
    """The flagship's training configuration (``__graft_entry__``'s
    ``_flagship_cfg()``: bf16 compute, fp32 master params, remat "dots"),
    attending through the flash kernels."""
    from pbs_tpu_torch.models import TransformerConfig

    return TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16, remat=True,
                             remat_policy="dots", attn_impl="pallas")


def bwd_counts():
    from pbs_tpu_torch.ops.attention import (flash_attention_bwd_dkv_cuda,
                                             flash_attention_bwd_dq_cuda,
                                             flash_attention_cuda)
    from pbs_tpu_torch.ops.matmul import instrumented_matmul_cuda

    return (flash_attention_cuda, flash_attention_bwd_dq_cuda,
            flash_attention_bwd_dkv_cuda, instrumented_matmul_cuda)


def reset_counts(wrappers) -> None:
    """Set every launch count of the wrappers to 0, per route too where
    a wrapper has routes."""
    from pbs_tpu_torch.ops.cuda_build import new_route_counts

    for w in wrappers:
        w.launches = 0
        if hasattr(w, "launches_by_route"):
            w.launches_by_route = new_route_counts()


def training_tenant(torch, gen, n_steps: int) -> dict:
    """The flagship training tenant: fresh fp32 master params, a loader
    of n_steps x TRAIN_MICRO seeded micro-batches (and one spare the run
    never sees, for warm-up), the micro-step and the Job's micro-step
    function, which records each micro-batch's loss."""
    from pbs_tpu_torch.models import init_params, make_micro_train_step

    cfg = train_config(torch)
    params = init_params(cfg, gen, device="cuda")  # fp32 master params
    batches = torch.randint(0, cfg.vocab,
                            (n_steps * TRAIN_MICRO + 1, TRAIN_BATCH,
                             TRAIN_SEQ), device="cuda", generator=gen)
    cursor = [0]

    def next_batch(micro: int):
        # a loader: micro-batch after micro-batch of a seeded stream
        i = cursor[0]
        cursor[0] += 1
        return batches[i]

    init_state, micro_step = make_micro_train_step(
        cfg, n_micro=TRAIN_MICRO, learning_rate=TRAIN_LR,
        next_batch=next_batch)
    losses = []

    def train_fn(state):
        state, metrics = micro_step(state)
        losses.append(metrics["loss"])
        return state, metrics

    return dict(cfg=cfg, params=params, spare=batches[-1],
                init_state=init_state, micro_step=micro_step,
                train_fn=train_fn, losses=losses)


def run_train_path(torch, gen, serve_cfg, serve_params):
    """The micro-stepped training tenant beside the serving tenant.
    Returns (launch counts of this run, the flash kernels' launches by
    route, the training config, the trained params, the micro_step
    function and its final state)."""
    from pbs_tpu_torch.models.transformer import loss_and_grads
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    tenant = training_tenant(torch, gen, TRAIN_STEPS)
    cfg, params = tenant["cfg"], tenant["params"]
    init_state, micro_step = tenant["init_state"], tenant["micro_step"]
    train_fn, losses = tenant["train_fn"], tenant["losses"]
    n_micro_total = TRAIN_STEPS * TRAIN_MICRO

    serve_fn, serve_state = serving_tenant(torch, gen, serve_cfg,
                                           serve_params)
    # Warm up outside the partition: one loss/gradient pass on a batch
    # the run never sees (cuBLAS handles, the caching allocator), and one
    # serving batch.
    loss_and_grads(cfg, params, tenant["spare"])
    serve_fn(serve_state)
    torch.cuda.synchronize()
    watch = {"embed": params["embed"][:8].clone(),
             "wq": params["layers"]["wq"][0, :8].clone(),
             "head": params["head"][:, :8].clone()}

    be = CudaBackend()
    part = Partition("train", source=be)
    check_native(part)
    fb = FeedbackPolicy(part)
    jobs = {
        "train": Job("train", micro_step_fn=train_fn,
                     micro_per_step=TRAIN_MICRO, state=init_state(params),
                     params=SchedParams(weight=512, tslice_us=100),
                     max_steps=TRAIN_STEPS),
        "serve": Job("serve", step_fn=serve_fn, state=serve_state,
                     params=SchedParams(weight=256, tslice_us=100,
                                        boost_on_wake=True),
                     max_steps=STEPS["serve"]),
    }
    for job in jobs.values():
        part.add_job(job)
    wrappers = bwd_counts()
    reset_counts(wrappers)
    t0 = time.monotonic()
    quanta = part.run()
    wall = time.monotonic() - t0
    launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "instrumented_matmul"),
                        (w.launches for w in wrappers)))
    routes = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                      (dict(w.launches_by_route) for w in wrappers[:3])))
    print(f"  {quanta} quanta in {wall:.2f} s wall; kernel launches "
          f"{launches}; by route {routes}", flush=True)
    print_tenants(jobs, Counter)
    print(f"  feedback: {json.dumps(fb.dump())}")
    loss_vals = [float(x) for x in losses]
    print(f"  micro-step losses {[round(x, 4) for x in loss_vals]}")

    train, ctx = jobs["train"], jobs["train"].contexts[0]
    for name, job in jobs.items():
        check(job.error is None and job.steps_retired() == job.max_steps,
              f"{name}: {job.steps_retired()} steps retired, no fault "
              f"({job.error})")
        snap = part.ledger.snapshot(job.contexts[0].ledger_slot)
        check(snap.tolist() == job.contexts[0].counters.tolist(),
              f"{name}: ledger snapshot equals the context counters")
    check(train.state["step"] == TRAIN_STEPS and train.state["micro"] == 0
          and ctx.micro_progress == 0,
          f"train: {train.state['step']} optimizer steps, micro cursor "
          f"{train.state['micro']}, progress {ctx.micro_progress}")
    tokens = int(ctx.counters[Counter.TOKENS])
    want = TRAIN_STEPS * TRAIN_MICRO * TRAIN_BATCH * (TRAIN_SEQ - 1)
    check(tokens == want, f"train: ledger TOKENS {tokens} == {TRAIN_STEPS} "
                          f"x {TRAIN_MICRO} x {TRAIN_BATCH} x "
                          f"{TRAIN_SEQ - 1}")
    yields = int(ctx.counters[Counter.YIELDS])
    check(yields > 0, f"train: {yields} yields, cut at chunk boundaries")
    check(len(loss_vals) == n_micro_total
          and all(math.isfinite(x) for x in loss_vals),
          f"train: {len(loss_vals)} micro-step losses, all finite")
    moved = {
        "embed": max_abs(params["embed"][:8], watch["embed"]),
        "wq": max_abs(params["layers"]["wq"][0, :8], watch["wq"]),
        "head": max_abs(params["head"][:, :8], watch["head"]),
    }
    check(all(x > 0 for x in moved.values()),
          f"train: params moved (max |delta| {moved})")
    check_served(jobs["serve"], Counter)
    per_step = cfg.n_layers * n_micro_total
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == per_step,
              f"{name}: {launches[name]} launches == {cfg.n_layers} layers "
              f"x {n_micro_total} micro-steps")
    check(launches["flash_fwd"] == 2 * per_step,
          f"flash_fwd: {launches['flash_fwd']} launches == 2 x "
          f"{per_step}: each layer's forward, and its recompute in the "
          f"backward under remat")
    for name, r in routes.items():
        check(r == {"wgmma": launches[name], "simt": 0},
              f"{name}: every launch on the tensor-core route ({r})")
    ms = int(ctx.counters[Counter.DEVICE_TIME_NS]) / 1e6 / n_micro_total
    print(f"  train: {ms:.2f} ms per micro-step (ledger device time / "
          f"{n_micro_total})", flush=True)
    return launches, routes, cfg, params, micro_step, train.state


# -- phase 3m ----------------------------------------------------------------


def warm_profiler(torch) -> float:
    """One throwaway torch.profiler session with CUDA activity: CUPTI's
    first start can take seconds, which would otherwise land in the
    first sampled quantum's device time. Returns its wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1 << 20, device="cuda").mul_(2)
        torch.cuda.synchronize()
    return time.monotonic() - t0


def roofline_frac(be, metrics: dict) -> float:
    """The stall fraction the backend itself charges a step with these
    counted FLOPs and bytes before its first sample: one second charged
    with no measured sample, read back from HBM_STALL_NS."""
    import numpy as np

    from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS, Counter

    deltas = np.zeros(NUM_COUNTERS, dtype=np.uint64)
    be._charge(deltas, 10 ** 9, 0, 0, metrics, measured=None)
    return int(deltas[Counter.HBM_STALL_NS]) / 10 ** 9


def run_measured_path(torch, gen, cfg, params, built) -> tuple:
    """serve, score, mm and the micro-stepped training Job in one
    Partition under FeedbackPolicy, with CudaBackend sampling every
    MEASURED_PROFILE_EVERY-th invocation of each tenant through
    torch.profiler, a CompileAdmission that admits all four, and an
    overflow sample armed on serve's TOKENS. Returns (launch counts of
    this run, launches by route)."""
    from pbs_tpu_torch.models.transformer import loss_and_grads
    from pbs_tpu_torch.runtime import (CompileAdmission, CompileBudget, Job,
                                       Partition, SchedParams, Virq)
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import CompileMeter, Counter, CudaBackend

    meter = CompileMeter.install()
    n_built = sum(1 for r in built.values() if r.seconds > 0)
    ambient = meter.peek_all().get("<ambient>", (0, 0))
    print(f"  compile meter: {meter.total_compiles} nvcc runs, "
          f"{meter.total_compile_ns / 1e9:.1f} s (mean "
          f"{meter.mean_compile_ns / 1e9:.1f} s), unattributed "
          f"{ambient}; phase 1 built {n_built} sources", flush=True)
    check(meter.total_compiles == n_built and ambient[0] == n_built,
          f"phase 1's build went through the CompileMeter: "
          f"{meter.total_compiles} compiles == {n_built} sources nvcc "
          f"built in this run, all unattributed")

    serve_fn, serve_state = serving_tenant(torch, gen, cfg, params)
    score_fn = scoring_tenant(torch, gen, cfg, params)
    mm_fn = mm_tenant(torch, gen)
    tenant = training_tenant(torch, gen, MEASURED_TRAIN_STEPS)
    # Warm every tenant outside the partition, then CUPTI.
    for fn, st in ((serve_fn, serve_state), (score_fn, None), (mm_fn, None)):
        fn(st)
    loss_and_grads(tenant["cfg"], tenant["params"], tenant["spare"])
    torch.cuda.synchronize()
    print(f"  profiler warm-up session: {warm_profiler(torch):.2f} s",
          flush=True)

    be = CudaBackend(profile_every=MEASURED_PROFILE_EVERY)
    gate = CompileAdmission(CompileBudget(
        max_programs=4, budget_ns=MEASURED_COMPILE_BUDGET_NS))
    part = Partition("measured", source=be, compile_admission=gate)
    check_native(part)
    fb = FeedbackPolicy(part)

    def params_(weight):
        return SchedParams(weight=weight, tslice_us=MEASURED_TSLICE_US)

    jobs = {
        "serve": Job("serve", step_fn=serve_fn, state=serve_state,
                     params=params_(256),
                     max_steps=MEASURED_STEPS["serve"]),
        "score": Job("score", step_fn=score_fn, params=params_(256),
                     max_steps=MEASURED_STEPS["score"]),
        "mm": Job("mm", step_fn=mm_fn, params=params_(512),
                  max_steps=MEASURED_STEPS["mm"]),
        "train": Job("train", micro_step_fn=tenant["train_fn"],
                     micro_per_step=TRAIN_MICRO,
                     state=tenant["init_state"](tenant["params"]),
                     params=params_(512), max_steps=MEASURED_TRAIN_STEPS),
    }
    for job in jobs.values():
        part.add_job(job)
    print(f"  compile admission: {json.dumps(gate.dump())}")
    period = SERVE_BATCH * SERVE_NEW  # one served batch of tokens
    serve_ctx = jobs["serve"].contexts[0]
    sid = part.sampler.arm(serve_ctx, Counter.TOKENS, period=period)
    virqs = []
    part.events.bind_virq(Virq.TELEMETRY, virqs.append)

    wrappers = bwd_counts()
    reset_counts(wrappers)
    t0 = time.monotonic()
    quanta = part.run()
    wall = time.monotonic() - t0
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "instrumented_matmul")
    launches = dict(zip(names, (w.launches for w in wrappers)))
    routes = dict(zip(names, (dict(w.launches_by_route) for w in wrappers)))
    part.events.deliver_pending()
    print(f"  profile_every={MEASURED_PROFILE_EVERY}: {quanta} quanta in "
          f"{wall:.2f} s wall; {be.profiler.samples} samples, "
          f"{be.profiler.failures} failures ({be.profiler.last_error}); "
          f"kernel launches {launches}; by route {routes}", flush=True)
    print_tenants(jobs, Counter)
    print(f"  feedback: {json.dumps(fb.dump())}")

    roof_mm = roofline_frac(be, mm_fn(None)[1])
    # Charged device ms of a sampled and an unsampled invocation, and
    # the profiler's own ms per sample (kept out of the charge).
    print(f"  {'tenant':<6} {'stall':>6} {'compute':>7} {'coll':>5} "
          f"{'roofline':>8} {'ops':>5} {'busy_ms':>8} {'sampled_ms':>10} "
          f"{'unsampled_ms':>12} {'profiler_ms':>11}  top ops")
    for name, job in jobs.items():
        m = be.measured(name)
        if m is None:
            print(f"  {name:<6} no sample")
            continue
        busy = m.compute_ns + m.memory_ns + m.collective_ns
        # only mm counts FLOPs and bytes: the others have no estimate
        roof = f"{roof_mm:.3f}" if name == "mm" else "none"
        n_s, s_ns, p_ns = be.profile_cost.get(name, (0, 0, 0))
        n_u = job.max_steps * job.micro_per_step - n_s
        u_ns = int(job.contexts[0].counters[Counter.DEVICE_TIME_NS]) - s_ns
        top = "; ".join(f"{k[:48]} {v / 1e6:.3f} ms" for k, v in m.top_ops[:3])
        print(f"  {name:<6} {m.stall_frac:>6.3f} "
              f"{m.compute_ns / busy if busy else 0.0:>7.3f} "
              f"{m.collective_frac:>5.3f} {roof:>8} {m.n_ops:>5} "
              f"{m.device_time_ns / 1e6:>8.3f} "
              f"{s_ns / n_s / 1e6 if n_s else 0.0:>10.2f} "
              f"{u_ns / n_u / 1e6 if n_u else 0.0:>12.2f} "
              f"{p_ns / n_s / 1e6 if n_s else 0.0:>11.2f}  {top}", flush=True)

    for name, job in jobs.items():
        check(job.error is None and job.steps_retired() == job.max_steps,
              f"{name}: {job.steps_retired()} steps retired, no fault "
              f"({job.error})")
    check(be.profiler.failures == 0 and be.profiler.samples >= len(jobs),
          f"profiler: {be.profiler.samples} samples >= one per job, "
          f"{be.profiler.failures} failures")
    measured = {name: be.measured(name) for name in jobs}
    for name, m in measured.items():
        check(m is not None and m.source == "device" and m.n_ops > 0,
              f"{name}: measured from the device lane "
              f"({m.source if m else None}, {m.n_ops if m else 0} ops)")
    check(measured["train"].stall_frac > measured["mm"].stall_frac,
          f"measured stall: train {measured['train'].stall_frac:.3f} > mm "
          f"{measured['mm'].stall_frac:.3f}")
    check(measured["mm"].stall_frac < roof_mm,
          f"mm: measured stall {measured['mm'].stall_frac:.3f} < its "
          f"roofline estimate {roof_mm:.3f}")
    events = part.sampler.drain()
    before = part.sampler.dump()[0]
    tokens = int(serve_ctx.counters[Counter.TOKENS])
    check(len(events) == 1 and events[0].seq == 1
          and events[0].threshold == period and events[0].value >= period
          and virqs == [int(Virq.TELEMETRY)] and not before["armed"]
          and before["fired"] == 1 and tokens >= 2 * period,
          f"serve TOKENS overflow at {period}: fired once "
          f"({[(e.value, e.seq) for e in events]}, virqs {virqs}) and "
          f"stayed disarmed to {tokens} tokens")
    part.sampler.rearm(sid)
    after = part.sampler.dump()[0]
    check(after["armed"] and after["threshold"] == tokens + period,
          f"serve TOKENS sample rearmed at {after['threshold']}")
    for name, job in jobs.items():
        ctx = job.contexts[0]
        n_c = int(ctx.counters[Counter.COMPILES])
        check(n_c == 0 and int(ctx.counters[Counter.COMPILE_TIME_NS]) == 0,
              f"{name}: ledger COMPILES {n_c}, phase 1 built everything")
        snap = part.ledger.snapshot(ctx.ledger_slot)
        check(snap.tolist() == ctx.counters.tolist(),
              f"{name}: ledger snapshot equals the context counters")
    for name, n in launches.items():
        check(n > 0 and routes[name] == {"wgmma": n, "simt": 0},
              f"{name}: {n} launches, every one on the tensor-core route "
              f"({routes[name]})")
    losses = [float(x) for x in tenant["losses"]]
    check(len(losses) == MEASURED_TRAIN_STEPS * TRAIN_MICRO
          and all(math.isfinite(x) for x in losses),
          f"train: {len(losses)} micro-step losses, all finite")
    return launches, routes


# -- phase 3s ----------------------------------------------------------------


def engine_script():
    """The seeded request script: (prompt, max_new) pairs and, for each
    tick, the indices arriving then (ENGINE_FIRST at tick 0, then
    ENGINE_PER_TICK a tick); the last ENGINE_REPEATS prompts repeat the
    first ones exactly."""
    import numpy as np

    rng = np.random.default_rng(ENGINE_SEED)
    reqs = []
    for i in range(ENGINE_REQUESTS):
        plen = int(rng.integers(ENGINE_PROMPT[0], ENGINE_PROMPT[1] + 1))
        prompt = rng.integers(0, FLAGSHIP["vocab"], plen).astype(np.int32)
        reqs.append((prompt, int(rng.integers(ENGINE_NEW[0],
                                              ENGINE_NEW[1] + 1))))
    n_new = ENGINE_REQUESTS - ENGINE_REPEATS
    for i in range(ENGINE_REPEATS):
        reqs[n_new + i] = (reqs[i][0].copy(), reqs[n_new + i][1])
    arrivals = {0: list(range(ENGINE_FIRST))}
    for i in range(ENGINE_FIRST, ENGINE_REQUESTS):
        tick = 1 + (i - ENGINE_FIRST) // ENGINE_PER_TICK
        arrivals.setdefault(tick, []).append(i)
    return reqs, arrivals


def engine_ticks(budgets: list, arrivals: dict, n_slots: int) -> int:
    """Ticks a continuous-batching engine needs to finish these requests
    (no EOS): each tick admits queued requests into free slots in slot
    order (the prefill samples a request's first token), retires what is
    already done, then decodes one token for every busy slot; a request
    retires in the tick that samples its last token."""
    from collections import deque

    queue, busy, left = deque(), [False] * n_slots, [0] * n_slots
    done = tick = 0
    while done < len(budgets):
        queue.extend(arrivals.get(tick, []))
        for s in range(n_slots):
            if not busy[s] and queue:
                busy[s], left[s] = True, budgets[queue.popleft()] - 1
        for s in range(n_slots):
            if busy[s] and not left[s]:
                busy[s], done = False, done + 1
        for s in range(n_slots):
            if busy[s]:
                left[s] -= 1
                if not left[s]:
                    busy[s], done = False, done + 1
        tick += 1
    return tick


def drive_engine(torch, eng, reqs, arrivals) -> dict:
    """Feed the script to an engine tick by tick until it drains. Returns
    completions by request index, each tick's host ms (the tick ends in
    the read of its sampled tokens, a device synchronise) with its
    number of admissions, and the wall seconds."""
    rid_of, done, ticks = {}, {}, []
    t0 = time.monotonic()
    tick = 0
    while tick <= max(arrivals) or eng.has_work():
        for i in arrivals.get(tick, []):
            rid_of[eng.submit(*reqs[i])] = i
        t = time.monotonic()
        for c in eng.step():
            done[rid_of[c.request_id]] = c
        ticks.append(((time.monotonic() - t) * 1e3, len(eng._admitted)))
        tick += 1
    return dict(done=done, ticks=ticks, wall=time.monotonic() - t0)


def decode_tick_ms(ticks) -> float:
    """Median host ms of the ticks that admitted nothing."""
    return statistics.median(ms for ms, admitted in ticks if not admitted)


def engine_line(name, eng, wall, tick_ms, prefill_ms, lockstep_ms, card,
                extra="") -> str:
    """One engine's numbers: ``stats()``'s TTFT and latency percentiles,
    the median decode tick, a prefill, tokens/s over the run's wall time
    and, beside them, the lockstep serve tenant's ms per token (phase
    3's ledger), then the card."""
    st = eng.stats()
    tok_s = st["tokens_emitted"] / wall
    return (f"  {name}: completed {st['completed']}, prefix hits "
            f"{st['prefix_hits']}; TTFT p50 {st['ttft_p50_s'] * 1e3:.2f} / "
            f"p99 {st['ttft_p99_s'] * 1e3:.2f} ms, latency p50 "
            f"{st['latency_p50_s'] * 1e3:.2f} / p99 "
            f"{st['latency_p99_s'] * 1e3:.2f} ms (host clock); decode tick "
            f"{tick_ms:.2f} ms (median), prefill {prefill_ms:.2f} ms; "
            f"{tok_s:.1f} tok/s ({1e3 / tok_s:.3f} ms per token) over "
            f"{st['steps']} ticks, {wall:.2f} s{extra}; lockstep serve "
            f"tenant (phase 3) {lockstep_ms:.3f} ms per token [{card}]")


def profile_ticks(torch, eng, n: int, card: str) -> None:
    """``n`` decode ticks of a busy engine under torch.profiler: host ms
    per tick, device busy ms and kernels per tick, the device's idle
    share, the top kernels. A measurement, not a check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    busy_slots = int(eng.active.sum())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(device_self_us(e) for e in dev)
    if busy <= 0:
        print("  profiled decode ticks: no device time recorded; not "
              "measured", flush=True)
        return
    kernels = sum(e.count for e in dev)
    print(f"  profiled decode ticks ({n}, {busy_slots} slots busy): "
          f"{wall_us / n / 1e3:.2f} ms per tick (profiler on), "
          f"{busy / n / 1e3:.3f} ms device busy, {kernels / n:.0f} kernels "
          f"per tick, idle share {1 - busy / wall_us:.3f} [{card}]",
          flush=True)
    for e in sorted(dev, key=device_self_us, reverse=True)[:5]:
        print(f"    {device_self_us(e) / n / 1e3:8.3f} ms/tick  "
              f"x{e.count // n:<4} {e.key[:90]}")


def time_prefill(torch, eng, prompt) -> float:
    """Median host ms of three prefills of ``prompt`` into slot 0 of an
    idle engine (each ends in the read of its first token); the slot is
    left free."""
    import numpy as np

    padded = np.zeros(eng.bucket, np.int32)
    padded[:len(prompt)] = prompt
    out = []
    for _ in range(3):
        t = time.monotonic()
        int(eng._prefill(0, padded, len(prompt))[0])
        out.append((time.monotonic() - t) * 1e3)
    eng.cache["pos"][0] = 0
    return statistics.median(out)


def lockstep_margin(torch, cfg, params, prompt, toks, j, fwd=None) -> float:
    """The lockstep run's top-2 fp32 logit gap at output position j, over
    the larger logit's magnitude: a B=1 prefill, then decodes of its
    tokens[:j], as ``make_generate`` computes them (``fwd``, the cached
    forward ``(cfg, params, tokens, cache) -> (logits, cache, ...)``:
    the dense one unless given)."""
    from pbs_tpu_torch.models import forward_with_cache, init_cache

    fwd = fwd or forward_with_cache
    cache = init_cache(cfg, 1, max_len=len(prompt) + j + 1, device="cuda")
    with torch.no_grad():
        logits, cache = fwd(
            cfg, params, torch.tensor(prompt[None], device="cuda"),
            cache)[:2]
        for t in toks[:j]:
            logits, cache = fwd(
                cfg, params, torch.tensor([[t]], device="cuda"), cache)[:2]
    top = logits[0, -1].topk(2).values
    return float(top[0] - top[1]) / float(top[0].abs())


def compare_tokens(torch, cfg, params, reqs, got: dict, want: dict,
                   what: str, fwd=None, tie: float = ENGINE_TIE) -> list:
    """Request by request, ``got`` against ``want`` (token lists). A
    divergence passes only where the lockstep run's top-2 logits at
    that position are within ``tie`` (relative to the top one) of each
    other (a tie two GEMM shapes may break differently); it is printed
    either way. Returns the divergences as (request, position, margin)."""
    ties = []
    for i, w in want.items():
        g = got[i]
        j = next((n for n, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            check(len(g) == len(w), f"{what}: request {i} has {len(g)} "
                                    f"tokens == {len(w)}")
            continue
        margin = lockstep_margin(torch, cfg, params, reqs[i][0], w, j, fwd)
        print(f"  {what}: request {i} diverges at token {j} ({g[j]} vs "
              f"{w[j]}); lockstep top-2 gap {margin:.3e} of |top-1|",
              flush=True)
        check(margin < tie, f"{what}: request {i}'s divergence is a "
                            f"near-tie (gap {margin:.3e} < {tie:g})")
        ties.append((i, j, margin))
    return ties


def run_engine_path(torch, gen, cfg, params, serve_ms_per_token, card):
    """Phase 3s: (a) the bf16 engine as a tenant beside score and mm,
    (b) an fp32 engine token-exact against the lockstep generate, (c) the
    speculative engine against (b), (d) int8 weight-only serving.
    Returns the launch counts and routes of (a)'s run."""
    from pbs_tpu_torch.models import (ContinuousBatcher, SpeculativeBatcher,
                                      TransformerConfig, cast_params,
                                      init_params, make_continuous_serve_step,
                                      make_generate, prefill,
                                      quantize_weights, quantized_nbytes)
    import numpy as np

    from pbs_tpu_torch.models.generate import init_cache
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams, nbytes_of
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    t_phase = time.monotonic()
    reqs, arrivals = engine_script()
    budgets = [n for _, n in reqs]
    n_ticks = engine_ticks(budgets, arrivals, ENGINE_SLOTS)
    print(f"  script: {len(reqs)} requests, prompts "
          f"{min(len(p) for p, _ in reqs)}-{max(len(p) for p, _ in reqs)} "
          f"tokens, budgets {min(budgets)}-{max(budgets)} ({sum(budgets)} "
          f"tokens), {ENGINE_FIRST} at tick 0 then {ENGINE_PER_TICK} a tick; "
          f"{n_ticks} ticks with {ENGINE_SLOTS} slots", flush=True)
    kw = dict(n_slots=ENGINE_SLOTS, prompt_bucket=ENGINE_BUCKET,
              max_len=ENGINE_MAX_LEN, prefix_cache_size=ENGINE_PREFIX)

    # (a) the bf16 engine as a scheduled tenant beside score and mm
    t0 = time.monotonic()
    eng = ContinuousBatcher(cfg, params, **kw)
    built_s = time.monotonic() - t0
    serve_step = make_continuous_serve_step(
        eng, next_requests=lambda t: [reqs[i] for i in arrivals.get(t, [])])
    ticks = []
    # each request's tokens, for phase 3g: engine ids follow submit order
    order = [i for t in sorted(arrivals) for i in arrivals[t]]
    index_of, a_tokens = {}, {}
    eng.submit_hook = lambda rid, *_: index_of.setdefault(
        rid, order[len(index_of)])
    engine_step = eng.step

    def recording_step():
        done = engine_step()
        for c in done:
            a_tokens[index_of[c.request_id]] = list(c.tokens)
        return done

    eng.step = recording_step

    def engine_fn(state):
        t = time.monotonic()
        out = serve_step(state)
        ticks.append(((time.monotonic() - t) * 1e3, len(eng._admitted)))
        return out

    score_fn = scoring_tenant(torch, gen, cfg, params)
    mm_fn = mm_tenant(torch, gen)
    for fn in (score_fn, mm_fn):
        fn(None)
    torch.cuda.synchronize()
    part = Partition("engine", source=CudaBackend(profile_every=0))
    check_native(part)
    fb = FeedbackPolicy(part)
    jobs = {
        "engine": Job("engine", step_fn=engine_fn,
                      state={"step": 0, "completed": 0},
                      params=SchedParams(weight=256, tslice_us=100,
                                         boost_on_wake=True),
                      max_steps=n_ticks),
        "score": Job("score", step_fn=score_fn, params=SchedParams(weight=256),
                     max_steps=STEPS["score"]),
        "mm": Job("mm", step_fn=mm_fn, params=SchedParams(weight=512),
                  max_steps=STEPS["mm"]),
    }
    for job in jobs.values():
        part.add_job(job)
    wrappers = bwd_counts()
    reset_counts(wrappers)
    t0 = time.monotonic()
    quanta = part.run()
    wall = time.monotonic() - t0
    eng.submit_hook, eng.step = None, engine_step
    launches = dict(zip(KERNELS, (w.launches for w in wrappers)))
    routes = dict(zip(KERNELS, (dict(w.launches_by_route)
                                for w in wrappers)))
    print(f"  (a) engine built (warm-up included) in {built_s:.2f} s; "
          f"{quanta} quanta in {wall:.2f} s wall; kernel launches "
          f"{launches}, by route {routes}", flush=True)
    print_tenants(jobs, Counter)
    print(f"  feedback: {json.dumps(fb.dump())}")
    for name, job in jobs.items():
        check(job.error is None and job.steps_retired() == job.max_steps,
              f"{name}: {job.steps_retired()} steps retired, no fault "
              f"({job.error})")
    st = eng.stats()
    ctx = jobs["engine"].contexts[0]
    tokens = int(ctx.counters[Counter.TOKENS])
    check(st["completed"] == len(reqs) == jobs["engine"].state["completed"]
          and not eng.has_work(),
          f"(a) engine: {st['completed']} of {len(reqs)} requests completed "
          f"in the {n_ticks} ticks the script needs")
    check(sorted(a_tokens) == list(range(len(reqs)))
          and all(len(a_tokens[i]) == n for i, (_, n) in enumerate(reqs)),
          "(a) engine: every request's tokens recorded, each its budget")
    check(tokens == eng.tokens_emitted == sum(budgets),
          f"(a) engine: ledger TOKENS {tokens} == tokens_emitted "
          f"{eng.tokens_emitted} == the budgets' sum {sum(budgets)}")
    check(st["prefix_hits"] == ENGINE_REPEATS
          and eng.prefill_count == len(reqs) - ENGINE_REPEATS,
          f"(a) engine: prefix hits {st['prefix_hits']} == {ENGINE_REPEATS}, "
          f"prefill_count {eng.prefill_count} == "
          f"{len(reqs) - ENGINE_REPEATS}")
    for name in ("flash_fwd", "instrumented_matmul"):
        n = launches[name]
        check(n > 0 and routes[name] == {"wgmma": n, "simt": 0},
              f"{name}: {n} launches beside the engine, every one on the "
              f"tensor-core route ({routes[name]})")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == 0,
              f"{name}: {launches[name]} launches beside the engine == 0 "
              f"(no training tenant in this run)")
    ms_eng = int(ctx.counters[Counter.DEVICE_TIME_NS]) / 1e6
    print(engine_line(
        "(a) bf16 engine (tenant)", eng, wall, decode_tick_ms(ticks),
        time_prefill(torch, eng, reqs[0][0]), serve_ms_per_token, card,
        f"; ledger {ms_eng / n_ticks:.2f} ms per tick, "
        f"{ms_eng / tokens:.3f} ms per token"), flush=True)
    # all 8 slots busy again (prefix hits, no prefill), then profiled
    for i in range(ENGINE_SLOTS):
        eng.submit(*reqs[i])
    eng.step()
    profile_ticks(torch, eng, ENGINE_PROFILED_TICKS, card)
    del eng
    print(f"  (a) wall {time.monotonic() - t_phase:.1f} s", flush=True)

    # (b) an fp32 engine, token-exact against the lockstep generate
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    master = init_params(cfg32, torch.Generator(device="cuda").manual_seed(
        ENGINE_SEED), device="cuda")
    first = {i: reqs[i] for i in range(ENGINE_FIRST)}
    first_arrivals = {0: list(first)}
    plain = ContinuousBatcher(cfg32, master, **kw)
    b = drive_engine(torch, plain, reqs, first_arrivals)
    b_toks = {i: c.tokens for i, c in b["done"].items()}
    check(sorted(b_toks) == list(first)
          and all(len(b_toks[i]) == reqs[i][1] for i in first),
          f"(b) fp32 engine: {len(b_toks)} requests, each with its budget")
    want = {}
    for i, (prompt, n) in first.items():
        out = make_generate(cfg32, n)(
            master, torch.tensor(prompt[None], device="cuda"))
        want[i] = out[0].tolist()
    ties = compare_tokens(torch, cfg32, master, reqs, b_toks, want,
                          "(b) fp32 engine vs lockstep make_generate (B=1)")
    print(f"  (b) fp32 engine token-exact against the lockstep generate on "
          f"{len(want) - len(ties)} of {len(want)} requests, the rest "
          f"near-ties {ties}", flush=True)
    print(engine_line("(b) fp32 engine", plain, b["wall"],
                      decode_tick_ms(b["ticks"]),
                      time_prefill(torch, plain, reqs[0][0]),
                      serve_ms_per_token, card),
          flush=True)
    b_steps = plain.stats()["steps"]
    del plain

    # (c) the speculative engine against (b)
    head = master["head"]
    noise = torch.randn(head.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(ENGINE_SEED + 1))
    draft = dict(master, head=head + ENGINE_DRAFT_NOISE * head.std() * noise)
    spec = SpeculativeBatcher(cfg32, master, cfg32, draft, k=ENGINE_K, **kw)
    c = drive_engine(torch, spec, reqs, first_arrivals)
    c_toks = {i: r.tokens for i, r in c["done"].items()}
    check(sorted(c_toks) == list(first),
          f"(c) speculative engine: {len(c_toks)} requests completed")
    spec_ties = compare_tokens(torch, cfg32, master, reqs, c_toks, b_toks,
                               "(c) speculative vs (b)'s engine")
    sst = spec.stats()
    check(sst["steps"] < b_steps,
          f"(c) speculative engine: {sst['steps']} ticks < (b)'s {b_steps}")
    print(engine_line("(c) fp32 speculative engine, k=4", spec, c["wall"],
                      decode_tick_ms(c["ticks"]),
                      time_prefill(torch, spec, reqs[0][0]),
                      serve_ms_per_token, card,
                      f"; spec_acceptance {sst['spec_acceptance']} "
                      f"({sst['spec_accepted']} of {sst['spec_proposed']}); "
                      f"near-ties {spec_ties}"), flush=True)
    del spec, draft, noise

    # (d) int8 weight-only serving at bf16 compute
    q = quantize_weights(master)
    bf16 = cast_params(master, cfg.dtype)
    del master
    q_bytes, b_bytes = quantized_nbytes(q), nbytes_of(bf16)
    check(q_bytes < ENGINE_INT8_BYTES * b_bytes,
          f"(d) int8 tree {q_bytes / 2**30:.3f} GiB < {ENGINE_INT8_BYTES} x "
          f"the bf16 tree's {b_bytes / 2**30:.3f} GiB")
    prompt = torch.tensor(reqs[0][0][None], device="cuda")
    with torch.no_grad():
        l16, _ = prefill(cfg, bf16, prompt,
                         init_cache(cfg, 1, len(reqs[0][0]), device="cuda"))
        l8, _ = prefill(cfg, q, prompt,
                        init_cache(cfg, 1, len(reqs[0][0]), device="cuda"))
    err = float((l16 - l8).abs().max()) / float(l16.std())
    check(bool(torch.isfinite(l8).all()) and err < ENGINE_INT8_LOGITS,
          f"(d) first request's prefill logits: max|l_bf16 - l_int8| / "
          f"std(l_bf16) = {err:.4f} < {ENGINE_INT8_LOGITS}")
    del bf16
    eng8 = ContinuousBatcher(cfg, q, **kw)
    d = drive_engine(torch, eng8, reqs, arrivals)
    check(sorted(d["done"]) == list(range(len(reqs)))
          and all(len(d["done"][i].tokens) == reqs[i][1]
                  for i in d["done"]),
          f"(d) int8 engine: all {len(d['done'])} requests completed with "
          f"their budgets")
    # the engine's own int8 prefill (padded bucket, slot slab, embed_rows
    # and unstack_layers on {"q","s"} leaves) against the lockstep one
    padded = np.zeros(eng8.bucket, np.int32)
    padded[:len(reqs[0][0])] = reqs[0][0]
    with torch.no_grad():
        le = eng8._prefill(0, padded, len(reqs[0][0]))[1].float()
    eng8.cache["pos"][0] = 0
    l8_last = l8[0].float()  # prefill's logits are (B, vocab)
    err = float((le - l8_last).abs().max()) / float(l8_last.std())
    check(bool(torch.isfinite(le).all()) and err < ENGINE_INT8_PATHS,
          f"(d) int8 engine's prefill logits against the lockstep prefill's "
          f"on the same int8 tree: max|diff| / std = {err:.3e} < "
          f"{ENGINE_INT8_PATHS}")
    print(engine_line("(d) int8 weight-only engine, bf16 compute", eng8,
                      d["wall"], decode_tick_ms(d["ticks"]),
                      time_prefill(torch, eng8, reqs[0][0]),
                      serve_ms_per_token, card),
          flush=True)
    del eng8, q
    print(f"  phase 3s wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, routes, a_tokens


# -- phase 3g ----------------------------------------------------------------


def gateway_quotas(TenantQuota):
    return {name: TenantQuota(rate=GW_RATE, burst=GW_BURST,
                              weight=GW_WEIGHTS[name],
                              slo="interactive" if name == "chat" else "batch",
                              max_queued=1 if name == "probe"
                              else GW_MAX_QUEUED)
            for name in GW_WEIGHTS}


def gateway_job(cfg, params, reqs, arrivals, fb, max_steps):
    """A fresh bf16 engine behind a fresh Gateway, wrapped as the Job
    ``gw``: each step submits the script's arrivals for this gateway tick
    (and, at tick 0, the two planned sheds), then runs ``gw.tick()`` once
    (one engine step). The Job ends at the tick that drains the gateway.
    Its queue-delay sink reports into ``fb``. Returns (job, gateway,
    engine, record), where record holds the submit results,
    completions, tick timings and slice trajectory."""
    from pbs_tpu_torch.gateway import (BatcherBackend, Gateway, TenantQuota,
                                       sched_feedback_sink)
    from pbs_tpu_torch.models import ContinuousBatcher
    from pbs_tpu_torch.runtime import Job, SchedParams
    from pbs_tpu_torch.utils.clock import MonotonicClock

    eng = ContinuousBatcher(cfg, params, n_slots=ENGINE_SLOTS,
                            prompt_bucket=ENGINE_BUCKET,
                            max_len=ENGINE_MAX_LEN,
                            prefix_cache_size=ENGINE_PREFIX)
    be = BatcherBackend("engine", eng)
    rec = dict(subs={}, sheds=[], done={}, tokens={}, ticks=[], fb=[],
               engine_ms=[0.0])
    # the gateway reports token counts; the tokens themselves are read
    # off the engine's completions, through the backend's own map from
    # engine id to gateway request (poll pops it after step returns)
    engine_step = eng.step

    def timed_step():
        t = time.monotonic()
        out = engine_step()
        rec["engine_ms"][0] += (time.monotonic() - t) * 1e3
        for c in out:
            rid = be._by_engine_rid[c.request_id].rid
            rec["tokens"][rid] = list(c.tokens)
        return out

    eng.step = timed_step
    job = Job("gw", params=SchedParams(weight=256, tslice_us=GW_TSLICE_US,
                                       boost_on_wake=False),
              max_steps=max_steps)

    def sink(cls, wait_ns, events):
        st = fb.state_of(job)
        before = (job.params.tslice_us, st.gw_boosts)
        sched_feedback_sink(fb, job)(cls, wait_ns, events)
        rec["fb"].append((before[0], job.params.tslice_us,
                          st.gw_boosts > before[1], wait_ns, events))

    gw = Gateway([be],
                 quotas=gateway_quotas(TenantQuota), clock=MonotonicClock(),
                 trace_capacity=GW_TRACE_CAPACITY, feedback_sink=sink)
    check("python" not in (gw.trace.tier, gw.hist.ledger.tier),
          f"gateway: ring on the {gw.trace.tier} tier, histograms on "
          f"{gw.hist.ledger.tier}")

    def submit(tenant, i, cost):
        prompt, n = reqs[i]
        r = gw.submit(tenant, {"prompt": prompt, "max_new": n}, cost=cost)
        if r.admitted:
            rec["subs"][r.rid] = (tenant, i)
        else:
            rec["sheds"].append((tenant, i, r.reason, r.retry_after_ns))

    def gw_fn(state):
        tick = state["tick"]
        if tick == 0:
            submit("chat", 0, int(GW_BURST) + 1)  # cost over the burst
            submit("probe", 0, reqs[0][1])
            submit("probe", 0, reqs[0][1])  # probe's queue is full
        for i in arrivals.get(tick, []):
            n = reqs[i][1]
            submit("chat" if n <= GW_CHAT_MAX_NEW else "bulk", i, n)
        before, eng_ms = eng.tokens_emitted, rec["engine_ms"][0]
        t = time.monotonic()
        for rid, info in gw.tick():
            rec["done"][rid] = info
        rec["ticks"].append(((time.monotonic() - t) * 1e3,
                             rec["engine_ms"][0] - eng_ms))
        if tick >= max(arrivals) and not gw.busy():
            job.max_steps = tick + 1  # drained: this is the last step
        return {"tick": tick + 1}, {"tokens": eng.tokens_emitted - before}

    job.step_fn, job.state = gw_fn, {"tick": 0}
    return job, gw, eng, rec


def check_gateway_run(what, gw, eng, rec, reqs, a_tokens, torch, cfg,
                      params) -> list:
    """Phase 3g's checks on one run: nothing lost, the planned sheds
    only, the engine's books equal the gateway's, payloads equal 3s(a)'s
    (or near-ties), one gapless span chain per admitted rid. Returns the
    near-ties."""
    from pbs_tpu_torch.gateway.admission import (PERMANENT_RETRY_NS,
                                                 SHED_REASON_CODES,
                                                 SHED_RETRY_NS)
    from pbs_tpu_torch.obs import Ev, SpanAssembler

    st = gw.stats()
    est = eng.stats()
    done = rec["done"]
    check(st["admitted"] == st["completed"] == len(reqs) + 1
          and st["inflight"] == st["queued"] == 0 and not gw.busy(),
          f"{what}: nothing lost — admitted {st['admitted']} == completed "
          f"{st['completed']} == {len(reqs)} + the probe's first, inflight "
          f"{st['inflight']}, queued {st['queued']}")
    check(sorted(done) == sorted(rec["subs"]),
          f"{what}: every admitted rid completed exactly once")
    want_sheds = [("chat", 0, "cost-over-burst", PERMANENT_RETRY_NS),
                  ("probe", 0, "tenant-queue-full", SHED_RETRY_NS)]
    check(rec["sheds"] == want_sheds
          and st["shed"] == {"cost-over-burst": 1, "tenant-queue-full": 1},
          f"{what}: the sheds are exactly the two planned ones "
          f"({rec['sheds']}, {st['shed']})")
    recs = gw.trace.consume(GW_TRACE_CAPACITY)
    check(gw.trace.lost == 0 and len(recs) < GW_TRACE_CAPACITY,
          f"{what}: the trace ring kept all {len(recs)} records")
    sheds = [r for r in recs.tolist() if r[1] == Ev.GW_SHED]
    check([r[4] for r in sheds] == [SHED_REASON_CODES["cost-over-burst"],
                                    SHED_REASON_CODES["tenant-queue-full"]],
          f"{what}: GW_SHED records carry the reason codes "
          f"{[r[4] for r in sheds]}")
    tokens = sum(info["tokens"] for info in done.values())
    check(est["completed"] == st["completed"] and st["bypass_submits"] == 0
          and est["tokens_emitted"] == tokens,
          f"{what}: engine completed {est['completed']} == the gateway's "
          f"completions, tokens_emitted {est['tokens_emitted']} == "
          f"{tokens}, bypass submits {st['bypass_submits']}")
    short = {rid: (info["tokens"], reqs[rec["subs"][rid][1]][1])
             for rid, info in done.items()
             if info["tokens"] != reqs[rec["subs"][rid][1]][1]}
    check(not short, f"{what}: every completion has its budget's tokens "
                     f"(those that do not, (tokens, budget): {short})")
    index = {rid: i for rid, (_, i) in rec["subs"].items()}
    ties = compare_tokens(torch, cfg, params,
                          {rid: reqs[i] for rid, i in index.items()},
                          rec["tokens"],
                          {rid: a_tokens[i] for rid, i in index.items()},
                          f"{what} vs 3s(a)'s direct engine")
    asm = SpanAssembler(recs, gw.spans.rid_table(),
                        gw.spans.member_table(), gw.spans.tenant_table())
    problems = asm.validate(sorted(rec["subs"]))
    summary = asm.summary()
    execs = sum(1 for chain in asm.chains.values()
                if any(ev == Ev.SPAN_EXEC for _, ev, *_ in chain))
    check(not problems and summary["chains"] == len(rec["subs"])
          and execs == len(rec["subs"]) and summary["shed_events"] == 2,
          f"{what}: one gapless span chain with an EXEC per admitted rid "
          f"({summary}, {execs} with EXEC), none for the 2 sheds; "
          f"problems {problems[:3]}")
    return ties


def gateway_lines(what, gw, eng, rec, wall, fb, job, card) -> dict:
    """Print one run's numbers; return the interactive latencies (ns,
    exact, from the completions) for the co-located/alone ratio."""
    from pbs_tpu_torch.utils.stats import nearest_rank

    st, est = gw.stats(), eng.stats()
    for cls, c in st["classes"].items():
        print(f"  {what} {cls}: qdelay p50/p99 {c['qdelay_p50_ns'] / 1e6:.3f}"
              f" / {c['qdelay_p99_ns'] / 1e6:.3f} ms, latency p50/p95/p99 "
              f"{c['latency_p50_ns'] / 1e6:.3f} / "
              f"{c['latency_p95_ns'] / 1e6:.3f} / "
              f"{c['latency_p99_ns'] / 1e6:.3f} ms (log2-bucket upper "
              f"edges, gw.stats())", flush=True)
    lat = {cls: sorted(i["latency_ns"] for i in rec["done"].values()
                       if i["slo"] == cls) for cls in st["classes"]}
    qd = {cls: sorted(i["queue_delay_ns"] for i in rec["done"].values()
                      if i["slo"] == cls) for cls in st["classes"]}
    for cls in lat:
        print(f"  {what} {cls}: {len(lat[cls])} requests, exact "
              f"nearest-rank qdelay p50/p99 "
              f"{nearest_rank(qd[cls], 0.5) / 1e6:.3f} / "
              f"{nearest_rank(qd[cls], 0.99) / 1e6:.3f} ms, latency "
              f"p50/p95/p99 {nearest_rank(lat[cls], 0.5) / 1e6:.3f} / "
              f"{nearest_rank(lat[cls], 0.95) / 1e6:.3f} / "
              f"{nearest_rank(lat[cls], 0.99) / 1e6:.3f} ms", flush=True)
    print(f"  {what} sheds by reason {st['shed']}; engine TTFT p50/p99 "
          f"{est['ttft_p50_s'] * 1e3:.2f} / {est['ttft_p99_s'] * 1e3:.2f} ms,"
          f" latency p50/p99 {est['latency_p50_s'] * 1e3:.2f} / "
          f"{est['latency_p99_s'] * 1e3:.2f} ms (eng.stats(), host clock)",
          flush=True)
    host = [tick - engine for tick, engine in rec["ticks"]]
    boosts = [(before, after) for before, after, boosted, _, _ in rec["fb"]
              if boosted]
    dump = next(d for d in fb.dump() if d["job"] == job.name)
    print(f"  {what} gw_reports {fb.state_of(job).gw_reports}, "
          f"gw_boosts {dump['gw_boosts']}; gw tslice_us start "
          f"{GW_TSLICE_US}, at the first report {rec['fb'][0][0]}, (before, "
          f"after) each boost {boosts}, end {rec['slice_end']}; the "
          f"stall-driven loop: grows {dump['grows']}, shrinks "
          f"{dump['shrinks']}, stall_rate {dump['stall_rate']}; "
          f"{est['tokens_emitted'] / wall:.1f} tok/s over {wall:.2f} s wall"
          f"{' (co-tenants included)' if 'co-located' in what else ''}; "
          f"{len(rec['ticks'])} gateway ticks, gateway host ms per tick "
          f"(tick minus engine step) median {statistics.median(host):.3f}, "
          f"max {max(host):.3f}, engine step median "
          f"{statistics.median(e for _, e in rec['ticks']):.2f} ms [{card}]",
          flush=True)
    return lat


def run_gateway_path(torch, gen, cfg, params, a_tokens, card):
    """Phase 3g: 3s's script through the port's gateway into a bf16
    engine, as the Job ``gw`` under FeedbackPolicy + CudaBackend, (a)
    beside score and mm, (b) alone, in the order a, b, b, a so that
    order is not taken for co-location. Returns the first (a)'s launch
    counts and routes."""
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import CudaBackend
    from pbs_tpu_torch.utils.stats import nearest_rank

    t_phase = time.monotonic()
    reqs, arrivals = engine_script()
    # an upper bound; the Job lowers it at the tick that drains
    bound = 4 * engine_ticks([n for _, n in reqs], arrivals, ENGINE_SLOTS)
    wrappers = bwd_counts()
    lats, result = {}, None
    for what in ("(a) co-located", "(b) alone", "(b) alone, again",
                 "(a) co-located, again"):
        part = Partition("gateway", source=CudaBackend(profile_every=0))
        check_native(part)
        fb = FeedbackPolicy(part)
        job, gw, eng, rec = gateway_job(cfg, params, reqs, arrivals, fb,
                                        bound)
        jobs = {"gw": job}
        if what.startswith("(a)"):
            score_fn = scoring_tenant(torch, gen, cfg, params)
            mm_fn = mm_tenant(torch, gen)
            for fn in (score_fn, mm_fn):
                fn(None)
            jobs["score"] = Job("score", step_fn=score_fn,
                                params=SchedParams(weight=256),
                                max_steps=STEPS["score"])
            jobs["mm"] = Job("mm", step_fn=mm_fn,
                             params=SchedParams(weight=512),
                             max_steps=STEPS["mm"])
        torch.cuda.synchronize()
        for j in jobs.values():
            part.add_job(j)
        reset_counts(wrappers)
        t0 = time.monotonic()
        quanta = part.run()
        wall = time.monotonic() - t0
        launches = dict(zip(KERNELS, (w.launches for w in wrappers)))
        routes = dict(zip(KERNELS, (dict(w.launches_by_route)
                                    for w in wrappers)))
        rec["slice_end"] = job.params.tslice_us
        print(f"  {what}: {quanta} quanta in {wall:.2f} s wall; kernel "
              f"launches {launches}, by route {routes}", flush=True)
        for name, j in jobs.items():
            check(j.error is None and j.finished(),
                  f"{what} {name}: {j.steps_retired()} steps retired, "
                  f"finished, no fault ({j.error})")
        ties = check_gateway_run(what, gw, eng, rec, reqs, a_tokens, torch,
                                 cfg, params)
        print(f"  {what}: {len(rec['tokens'])} payloads against 3s(a)'s "
              f"direct engine, near-ties {ties}", flush=True)
        st = fb.state_of(job)
        first = next((r for r in rec["fb"] if r[2]), None)
        check(st.gw_reports > 0 and st.gw_boosts >= 1
              and job.params.boost_on_wake and first is not None
              and first[1] < first[0],
              f"{what}: the loop closed — gw_reports {st.gw_reports}, "
              f"gw_boosts {st.gw_boosts}, boost_on_wake "
              f"{job.params.boost_on_wake}, slice at the first boost "
              f"{first[:2] if first else None} (before, after)")
        if what.startswith("(a)"):
            for name in ("flash_fwd", "instrumented_matmul"):
                n = launches[name]
                check(n > 0 and routes[name] == {"wgmma": n, "simt": 0},
                      f"{name}: {n} launches beside the gateway, every one "
                      f"on the tensor-core route ({routes[name]})")
            for name in ("flash_bwd_dq", "flash_bwd_dkv"):
                check(launches[name] == 0,
                      f"{name}: {launches[name]} launches beside the "
                      f"gateway == 0 (no training tenant)")
            if result is None:
                result = (launches, routes)
        lats[what] = gateway_lines(what, gw, eng, rec, wall, fb, job,
                                   card)["interactive"]
        del job, gw, eng, rec, part, fb, jobs
    # With a dozen interactive requests a run, nearest-rank p99 and p95 are
    # the run's largest latency: name the ratio for what it is, per
    # order, and beside it the medians'.
    (a1, b1, b2, a2) = lats.values()
    n = len(a1)
    for order, co, alone in (("a then b", a1, b1), ("b then a", a2, b2)):
        print(f"  interactive latency co-located / alone, run order "
              f"{order}, {n} requests a run: max (= nearest-rank p99 at "
              f"this n) {max(co) / 1e6:.3f} / {max(alone) / 1e6:.3f} ms = "
              f"{max(co) / max(alone):.3f}; median "
              f"{nearest_rank(co, 0.5) / 1e6:.3f} / "
              f"{nearest_rank(alone, 0.5) / 1e6:.3f} ms = "
              f"{nearest_rank(co, 0.5) / nearest_rank(alone, 0.5):.3f} "
              f"(recorded, no limit) [{card}]", flush=True)
    print(f"  phase 3g wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return result


def write_trace_fixture(torch, gen, path: str) -> None:
    """Profile one quantum of kernels 2.1-2.4 and a short tanh chain on
    the card and write its Chrome trace, trimmed to the device lane,
    its process names and a few host runtime calls, to ``path``."""
    import os
    import tempfile

    from pbs_tpu_torch.ops.attention import (flash_attention_bwd,
                                             flash_attention_cuda)
    from pbs_tpu_torch.ops.matmul import instrumented_matmul
    from pbs_tpu_torch.telemetry.profiler import (DEVICE_CATS,
                                                  TorchQuantumProfiler)

    a = torch.randn(512, 512, device="cuda", generator=gen).bfloat16()
    q, k, v = (torch.randn(1, 256, h, 128, device="cuda", generator=gen)
               .bfloat16() for h in (4, 2, 2))
    x = torch.randn(1 << 20, device="cuda", generator=gen)

    def quantum():
        instrumented_matmul(a, a, 256, 256, 256)
        o, lse = flash_attention_cuda(q, k, v, True)
        flash_attention_bwd(q, k, v, o, lse, o, None, True)
        y = x
        for _ in range(4):
            y = torch.tanh(y)
        torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        prof = TorchQuantumProfiler("cuda", keep_dir=tmp)
        _, stats = prof.profile(quantum)
        with open(os.path.join(tmp, "trace_0.json")) as f:
            doc = json.load(f)
    events = doc["traceEvents"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    pids = {e.get("pid") for e in device}
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"][:6]
    pids |= {e.get("pid") for e in runtime}
    meta = [e for e in events if e.get("ph") == "M" and e.get("pid") in pids]
    out = {"schemaVersion": doc.get("schemaVersion"),
           "deviceProperties": doc.get("deviceProperties"),
           "traceEvents": meta + runtime + device}
    with open(path, "w") as f:
        json.dump(out, f, indent=0)
    print(f"  trace fixture: {len(device)} device events, "
          f"{os.path.getsize(path)} bytes -> {path}; stall "
          f"{stats.stall_frac:.3f}, top {stats.top_ops[:4]}", flush=True)


# -- phase 3p ----------------------------------------------------------------


def state_digest(torch, state, device="cuda") -> list:
    """One int64 sum per leaf of the state's integer view (bf16 as int16,
    fp32 and int32 as int32), on ``device``, read in one transfer; Python
    scalars as they are. Equal digests: the same bits, leaf for leaf."""
    from pbs_tpu_torch.utils.tree import tree_leaves

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    sums, scalars = [], []
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            sums.append(leaf.view(ints[leaf.element_size()])
                        .sum(dtype=torch.int64).to(device))
        else:
            scalars.append(leaf)
    return torch.stack(sums).tolist() + scalars


def fixed_batch_loss(torch, cfg, state, tokens) -> float:
    """The forward-only loss of one fixed batch under a train state."""
    from pbs_tpu_torch.models import make_eval_step

    return float(make_eval_step(cfg)(state[0], tokens))


def paging_dir(phase: str = "3p"):
    """A scratch directory for a phase's files (3p's corpus, images and
    checkpoint; 3e's image) inside the checkout (git-ignored), and the
    bytes free on its disk."""
    import shutil
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_", dir=root)
    return tmp, shutil.disk_usage(tmp).free


def build_images(torch, cfg, tmp, device="cuda",
                 corpus_tokens=PAGING_CORPUS_TOKENS, batch=TRAIN_BATCH,
                 seq=TRAIN_SEQ):
    """The corpus (``corpus_tokens`` from a numpy seed) and two images of
    one manifest: ``cold`` and ``warm``, the latter holding the state a
    cold boot of ``cold`` on ``device`` reaches after one step on a
    corpus batch of (``batch``, ``seq``) — built the way ``boot_job``
    builds a state. Returns (the two image paths, the warm state's
    digest and bytes, the corpus path)."""
    import numpy as np

    from pbs_tpu_torch.data import write_token_file
    from pbs_tpu_torch.runtime import boot_job, nbytes_of, save_image

    rng = np.random.default_rng(PAGING_SEED)
    tokens = rng.integers(0, cfg.vocab, size=corpus_tokens)
    paths = {k: os.path.join(tmp, k) for k in ("cold", "warm")}
    os.makedirs(paths["cold"])
    os.makedirs(paths["warm"])
    corpus = os.path.join(paths["cold"], "corpus.tok")
    write_token_file(corpus, tokens)
    os.link(corpus, os.path.join(paths["warm"], "corpus.tok"))
    config = {k: getattr(cfg, k) for k in (
        *FLAGSHIP, "dtype", "remat", "remat_policy", "attn_impl")}
    kw = dict(train={"batch": batch, "seq": seq,
                     "learning_rate": TRAIN_LR, "seed": PAGING_SEED},
              data={"kind": "corpus", "path": "corpus.tok"})
    save_image(paths["cold"], "transformer", config, **kw)
    builder = boot_job(paths["cold"], name="builder", device=device)
    state, metrics = builder.step_fn(builder.state)
    loss = float(metrics["loss"])
    t0 = time.monotonic()
    save_image(paths["warm"], "transformer", config, state=state, **kw)
    save_s = time.monotonic() - t0
    digest, nbytes = state_digest(torch, state, device), nbytes_of(state)
    print(f"  image: {corpus_tokens} corpus tokens, state "
          f"{nbytes / 1e9:.3f} GB after one step (loss {loss:.4f}), "
          f"saved in {save_s:.2f} s ({nbytes / save_s / 1e9:.2f} GB/s)",
          flush=True)
    check(math.isfinite(loss) and state[2] == 1,
          f"image builder: one step, finite loss {loss:.4f}")
    return paths, digest, nbytes, corpus


def scorer_private_bytes(cfg) -> int:
    """What a 3p scorer holds of its own: its tokens (int64) and its
    last-position fp32 logits."""
    return SCORE_BATCH * SCORE_SEQ * 8 + SCORE_BATCH * cfg.vocab * 4


def shared_scorer(torch, cfg, params, tokens, name):
    """A scoring Job over ``params`` (the shared set): its state is the
    last-position logits of ``tokens``; it declares only its private
    bytes."""
    from pbs_tpu_torch.models import forward
    from pbs_tpu_torch.runtime import Job, SchedParams

    @torch.no_grad()
    def score_fn(state):
        logits = forward(cfg, params, tokens)[:, -1].float()
        return logits, {"tokens": tokens.numel()}

    return Job(name, step_fn=score_fn, state=None,
               mem_bytes=scorer_private_bytes(cfg),
               params=SchedParams(weight=256), max_steps=PAGING_SCORE_STEPS)


def run_until(part, done, what: str, limit: int = 64) -> int:
    """Partition rounds, one at a time, until ``done()``; returns how
    many ran."""
    rounds = 0
    while not done() and rounds < limit:
        part.run(max_rounds=1)
        rounds += 1
    check(done(), f"{what}: done in {rounds} rounds (at most {limit})")
    return rounds


def run_paging_path(torch, gen, card):
    """Phase 3p: memory admission and the tenant lifecycle at flagship
    width. Returns the launch counts and routes of its whole run."""
    import shutil

    from pbs_tpu_torch.ckpt import AsyncCheckpointer, restore_checkpoint
    from pbs_tpu_torch.data import (Prefetcher, ShardedBatchSource,
                                    TokenDataset)
    from pbs_tpu_torch.models import cast_params, make_train_step
    from pbs_tpu_torch.obs.perfc import perfc
    from pbs_tpu_torch.runtime import (MemoryManager, Partition,
                                       WeightsRegistry, boot_job, nbytes_of,
                                       register_paging_reclaim)
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import CudaBackend
    from pbs_tpu_torch.utils.tree import tree_leaves

    t_phase = time.monotonic()
    cfg = train_config(torch)
    score_cfg = dataclasses.replace(cfg, remat=False)
    state_bytes = 12 * cfg.num_params()  # fp32 params, mu, nu
    tmp, free = paging_dir()
    try:
        need = 2 * state_bytes + 4 * PAGING_CORPUS_TOKENS
        check(free >= need,
              f"disk: {free / 1e9:.1f} GB free for 3p's image and "
              f"checkpoint, needs {need / 1e9:.1f} GB"
              + ("" if free >= need else
                 f" (short by {(need - free) / 1e9:.1f} GB)"))
        wrappers = bwd_counts()
        reset_counts(wrappers)
        paths, saved, saved_bytes, corpus = build_images(torch, cfg, tmp)

        # 1. the card's memory as the manager reads it
        mm0 = MemoryManager.for_device()
        alloc = torch.cuda.memory_allocated()
        total = torch.cuda.mem_get_info()[1]
        print(f"  MemoryManager.for_device(): capacity {mm0.capacity} B, "
              f"reserve {mm0.reserve} B [{card}]", flush=True)
        check(mm0.capacity == total and mm0.reserve == alloc,
              f"for_device: capacity {mm0.capacity} == the card's total "
              f"{total}, reserve {mm0.reserve} == memory_allocated {alloc}")
        reserve = mm0.reserve

        # 3. image boot, warm: every leaf as saved
        t0 = time.monotonic()
        train_a = boot_job(paths["warm"], name="train-a")
        torch.cuda.synchronize()
        boot_s = time.monotonic() - t0
        a_bytes = nbytes_of(train_a.state)
        check(a_bytes == saved_bytes
              and state_digest(torch, train_a.state) == saved,
              f"train-a: warm boot in {boot_s:.2f} s, {a_bytes} B, digest "
              f"of all {len(saved)} leaves equal to the saved state's")

        # 2. one published copy of the bf16 weights for two scorers
        weights = cast_params(train_a.state[0], torch.bfloat16)
        w_bytes = nbytes_of(weights)
        private = 2 * scorer_private_bytes(score_cfg)
        # 4. the budget: train-a fits beside the scorers, a second
        # state of its size does not
        mm = MemoryManager(reserve + w_bytes + private + 3 * a_bytes // 2,
                           reserve_bytes=reserve)
        part = Partition("paging", source=CudaBackend(), memory=mm)
        check_native(part)
        fb = FeedbackPolicy(part)
        reg = WeightsRegistry(memory=mm)
        reg.publish("flagship", weights)
        del weights
        tokens = torch.randint(0, cfg.vocab, (SCORE_BATCH, SCORE_SEQ),
                               device="cuda", generator=gen)
        shared = [reg.acquire("flagship") for _ in range(2)]
        scorers = [shared_scorer(torch, score_cfg, p, tokens, n)
                   for p, n in zip(shared, ("score-a", "score-b"))]
        for job in scorers:
            part.add_job(job)
        ptrs = [[t.data_ptr() for t in tree_leaves(p)] for p in shared]
        check(mm.account("shared:flagship").used_bytes == w_bytes
              and reg.saved_bytes() == w_bytes and ptrs[0] == ptrs[1]
              and shared[0] is shared[1],
              f"shared weights: one account holds {w_bytes} B "
              f"({w_bytes / 1e9:.3f} GB), saved_bytes "
              f"{reg.saved_bytes()} == one set, both scorers hold the "
              f"same tensors (data_ptr)")
        del shared
        part.add_job(train_a)
        check(mm.account("train-a").used_bytes == a_bytes
              and mm.free_bytes() < a_bytes,
              f"admission: train-a claims {a_bytes} B; {mm.free_bytes()} "
              f"B left, less than a second state")
        t0 = time.monotonic()
        rounds = run_until(
            part, lambda: (all(j.finished() for j in scorers)
                           and train_a.steps_retired() >= PAGING_TRAIN_STEPS),
            "train-a beside the scorers")
        print(f"  beside the scorers: {rounds} rounds in "
              f"{time.monotonic() - t0:.2f} s; train-a at step "
              f"{train_a.state[2]}", flush=True)
        for job in (*scorers, train_a):
            check(job.error is None and job.steps_retired() > 0,
                  f"{job.name}: {job.steps_retired()} steps, no fault "
                  f"({job.error})")
        check(torch.equal(scorers[0].state, scorers[1].state)
              and bool(torch.isfinite(scorers[0].state).all()),
              "score-a and score-b: last-position logits of one batch "
              "bitwise equal, finite")

        # 4. paging under admission pressure
        ds = TokenDataset(corpus)
        fixed = torch.from_numpy(ds.window(0, TRAIN_BATCH, TRAIN_SEQ)).cuda()
        register_paging_reclaim(part, train_a)
        part.sleep_job(train_a)
        before = state_digest(torch, train_a.state)
        loss_before = fixed_batch_loss(torch, cfg, train_a.state, fixed)
        paged0 = perfc.get("paging_out_bytes")
        train_b = boot_job(paths["cold"], name="train-b")
        torch.cuda.synchronize()
        b_bytes = nbytes_of(train_b.state)
        alloc0 = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        part.add_job(train_b)
        out_s = time.monotonic() - t0
        alloc1 = torch.cuda.memory_allocated()
        out_bytes = perfc.get("paging_out_bytes") - paged0
        print(f"  page-out under train-b's claim: {out_bytes} B in "
              f"{out_s:.3f} s, {out_bytes / out_s / 1e9:.2f} GB/s "
              f"(pinned host allocation included); allocated "
              f"{alloc0} -> {alloc1} B [{card}]", flush=True)
        check(train_a.paged is not None
              and mm.account("train-a").used_bytes == 0
              and out_bytes == a_bytes == train_a.paged_bytes,
              f"train-a paged out by the balloon: account 0, perfc "
              f"paging_out_bytes +{out_bytes} == its state's {a_bytes} B")
        check(alloc0 - alloc1 >= 0.99 * out_bytes,
              f"HBM freed: memory_allocated fell by {alloc0 - alloc1} B >= "
              f"0.99 x {out_bytes} B")
        check(mm.account("train-b").used_bytes == b_bytes,
              f"train-b admitted: claims {b_bytes} B")
        train_b.max_steps = PAGING_B_STEPS
        part.run()
        check(train_b.error is None and train_b.finished(),
              f"train-b: {train_b.steps_retired()} steps, no fault "
              f"({train_b.error})")
        part.remove_job(train_b)
        train_b.state = None
        del train_b
        t0 = time.monotonic()
        part.wake_job(train_a)
        torch.cuda.synchronize()
        in_s = time.monotonic() - t0
        print(f"  page-in at wake: {a_bytes} B in {in_s:.3f} s, "
              f"{a_bytes / in_s / 1e9:.2f} GB/s [{card}]", flush=True)
        after = state_digest(torch, train_a.state)
        loss_after = fixed_batch_loss(torch, cfg, train_a.state, fixed)
        check(train_a.paged is None and after == before
              and mm.account("train-a").used_bytes == a_bytes,
              f"train-a paged in: digest of all {len(after)} leaves "
              f"bitwise equal, account {a_bytes} B again")
        check(loss_after == loss_before and math.isfinite(loss_after),
              f"train-a: fixed-batch loss {loss_after!r} == {loss_before!r} "
              f"before paging")
        lines = [ln["line"] for ln in train_a.console.read()["lines"]]
        check(f"paged out under pressure: {a_bytes} bytes to host" in lines
              and f"paged in: {a_bytes} bytes to device" in lines,
              "train-a's console: paged out under pressure, paged in")

        # 6. train on from the loader; 5. an async checkpoint meanwhile
        _, train_step = make_train_step(cfg, learning_rate=TRAIN_LR)
        src = ShardedBatchSource(ds, TRAIN_BATCH, TRAIN_SEQ,
                                 seed=PAGING_SEED)
        want = ShardedBatchSource(ds, TRAIN_BATCH, TRAIN_SEQ,
                                  seed=PAGING_SEED)
        seen, losses = [], []

        with Prefetcher(src, depth=2) as pf:
            def step_from_loader(state):
                batch = next(pf)
                seen.append(torch.equal(batch.cpu(),
                                        torch.from_numpy(want())))
                state, metrics = train_step(state, batch)
                losses.append(metrics["loss"])
                return state, metrics

            train_a.step_fn = step_from_loader
            run_until(part, lambda: len(seen) >= PAGING_AFTER_STEPS,
                      "train-a on the loader")
            ckpt = os.path.join(tmp, "async")
            digest = state_digest(torch, train_a.state)
            ck = AsyncCheckpointer()
            t0 = time.monotonic()
            ck.save(ckpt, train_a.state)
            blocked_s = time.monotonic() - t0
            # the next step runs while the write goes on
            run_until(part, lambda: len(seen) > PAGING_AFTER_STEPS,
                      "train-a's step under the checkpoint write")
            step_s = time.monotonic() - t0
            manifest = ck.wait()
            write_s = time.monotonic() - t0
        losses = [float(x) for x in losses]
        check(train_a.error is None and len(seen) >= PAGING_AFTER_STEPS + 1
              and all(seen) and all(math.isfinite(x) for x in losses),
              f"train-a trains on from the Prefetcher (depth 2): "
              f"{len(seen)} batches, each equal to its numpy window; "
              f"losses {[round(x, 4) for x in losses]} finite")
        print(f"  async checkpoint of {manifest['bytes']} B: caller blocked "
              f"{blocked_s:.3f} s (device-to-host snapshot), the next step "
              f"done at {step_s:.3f} s, published at {write_s:.3f} s "
              f"({manifest['bytes'] / write_s / 1e9:.2f} GB/s) [{card}]",
              flush=True)
        like = train_a.state
        restored, _ = restore_checkpoint(ckpt, like=like)
        got = state_digest(torch, restored)
        del restored, like
        check(got == digest and blocked_s < write_s,
              f"async checkpoint restores bitwise (digest of all "
              f"{len(got)} leaves); the caller was blocked "
              f"{blocked_s:.3f} s of the write's {write_s:.3f} s")
        ds.close()
        print(f"  feedback: {json.dumps(fb.dump())}")
        part.remove_job(train_a)
        for job in scorers:
            part.remove_job(job)
            reg.release("flagship")
        check(mm.dump()["accounts"] == {} and mm.free_bytes()
              == mm.capacity - mm.reserve,
              "every account closed at teardown")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), f"3p's files removed ({tmp})")
    launches = dict(zip(KERNELS, (w.launches for w in wrappers)))
    routes = dict(zip(KERNELS, (dict(w.launches_by_route)
                                for w in wrappers)))
    print(f"  kernel launches {launches}, by route {routes}", flush=True)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        n = launches[name]
        check(n > 0 and routes[name] == {"wgmma": n, "simt": 0},
              f"{name}: {n} launches in 3p, every one on the tensor-core "
              f"route ({routes[name]})")
    print(f"  phase 3p wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, routes


# -- phase 3e ----------------------------------------------------------------


def moe_config(**over):
    from pbs_tpu_torch.models import MoEConfig

    return MoEConfig(**MOE, **over)


def moe_train_image(torch, tmp) -> tuple:
    """The cold "moe" training image (a manifest only) and the config it
    boots, for the derivations beside the checks."""
    from pbs_tpu_torch.runtime import save_image

    path = os.path.join(tmp, "moe-train")
    over = dict(dtype="bfloat16", remat=True, attn_impl="pallas")
    save_image(path, "moe", {**MOE, **over},
               sched={"weight": 512, "tslice_us": 100},
               train={"batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                      "learning_rate": TRAIN_LR, "seed": MOE_SEED,
                      "max_steps": MOE_TRAIN_STEPS})
    return path, moe_config(**dict(over, dtype=torch.bfloat16))


def run_moe_path(torch, gen, serve_ms_per_token, card):
    """Phase 3e: (a) ``moe-train`` (booted cold from a "moe" image) and
    ``moe-serve`` (the bf16 dropless engine on 3s's script) in one
    Partition under FeedbackPolicy + CudaBackend; (b) an fp32 dropless
    engine token-exact against the lockstep ``make_moe_generate``; (c)
    the speculative engine with an MoE target and an MoE draft against
    (b). Returns (launch counts and routes of (a)'s run, the training
    job's step function and state, the fp32 MoE master params)."""
    import shutil

    from pbs_tpu_torch.models import (ContinuousBatcher, SpeculativeBatcher,
                                      cast_params, init_moe_params,
                                      make_continuous_serve_step,
                                      make_moe_generate)
    from pbs_tpu_torch.models.moe import (moe_forward_with_cache, moe_loss,
                                          moe_slot_mlp, routing_groups)
    from pbs_tpu_torch.models.transformer import value_and_grad
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams, boot_job
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    t_phase = time.monotonic()
    reqs, arrivals = engine_script()
    budgets = [n for _, n in reqs]
    n_ticks = engine_ticks(budgets, arrivals, ENGINE_SLOTS)
    kw = dict(n_slots=ENGINE_SLOTS, prompt_bucket=ENGINE_BUCKET,
              max_len=ENGINE_MAX_LEN, prefix_cache_size=ENGINE_PREFIX)

    # (a) moe-train, booted cold from a "moe" image, beside moe-serve
    tmp, _ = paging_dir("3e")
    try:
        path, tcfg = moe_train_image(torch, tmp)
        t0 = time.monotonic()
        train = boot_job(path, name="moe-train")
        torch.cuda.synchronize()
        boot_s = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    T = TRAIN_BATCH * (TRAIN_SEQ - 1)
    g, G, Cg = routing_groups(tcfg, T)
    params = train.state[0]
    check(train.max_steps == MOE_TRAIN_STEPS and train.params.weight == 512
          and tuple(params["layers"]["we1"].shape)
          == (MOE["n_layers"], MOE["n_experts"], MOE["d_model"], MOE["d_ff"])
          and (g, G, Cg) == (T, 1, 1279),
          f"moe-train booted cold from a \"moe\" image in {boot_s:.2f} s: "
          f"{tcfg.num_params() / 1e6:.1f}M params, experts "
          f"{tuple(params['layers']['we1'].shape)}, {T} routed tokens in "
          f"{G} group of {g}, capacity {Cg} per expert")
    spare = torch.randint(0, tcfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                          device="cuda", generator=gen)
    value_and_grad(lambda p: moe_loss(tcfg, p, spare), params)  # warm-up
    watch = {"embed": params["embed"][:8].clone(),
             "router": params["layers"]["router"][0].clone(),
             "we1": params["layers"]["we1"][0, 0, :8].clone(),
             "head": params["head"][:, :8].clone()}
    metrics, train_step = [], train.step_fn

    def train_fn(state):
        state, m = train_step(state)
        metrics.append(m)
        return state, m

    train.step_fn = train_fn

    scfg = moe_config(dtype=torch.bfloat16, dropless=True)
    cfg32 = moe_config(dtype=torch.float32, dropless=True)
    master = init_moe_params(cfg32, torch.Generator(device="cuda")
                             .manual_seed(MOE_SEED + 1), device="cuda")
    sparams = cast_params(master, torch.bfloat16)
    # the router stays fp32: the router product runs in fp32 anyway
    sparams["layers"]["router"] = master["layers"]["router"]
    eng = ContinuousBatcher(scfg, sparams, mlp_fn=moe_slot_mlp(scfg), **kw)
    serve_step = make_continuous_serve_step(
        eng, next_requests=lambda t: [reqs[i] for i in arrivals.get(t, [])])
    ticks = []

    def serve_fn(state):
        t = time.monotonic()
        out = serve_step(state)
        ticks.append(((time.monotonic() - t) * 1e3, len(eng._admitted)))
        return out

    torch.cuda.synchronize()
    part = Partition("moe", source=CudaBackend(profile_every=0))
    check_native(part)
    fb = FeedbackPolicy(part)
    jobs = {"moe-train": train,
            "moe-serve": Job("moe-serve", step_fn=serve_fn,
                             state={"step": 0, "completed": 0},
                             params=SchedParams(weight=256, tslice_us=100,
                                                boost_on_wake=True),
                             max_steps=n_ticks)}
    for job in jobs.values():
        part.add_job(job)
    wrappers = bwd_counts()
    reset_counts(wrappers)
    t0 = time.monotonic()
    quanta = part.run()
    wall = time.monotonic() - t0
    launches = dict(zip(KERNELS, (w.launches for w in wrappers)))
    routes = dict(zip(KERNELS, (dict(w.launches_by_route)
                                for w in wrappers)))
    print(f"  (a) {quanta} quanta in {wall:.2f} s wall; kernel launches "
          f"{launches}, by route {routes}", flush=True)
    print_tenants(jobs, Counter)
    print(f"  feedback: {json.dumps(fb.dump())}")
    for name, job in jobs.items():
        check(job.error is None and job.steps_retired() == job.max_steps,
              f"{name}: {job.steps_retired()} steps retired, no fault "
              f"({job.error})")
        snap = part.ledger.snapshot(job.contexts[0].ledger_slot)
        check(snap.tolist() == job.contexts[0].counters.tolist(),
              f"{name}: ledger snapshot equals the context counters")
    tokens = int(train.contexts[0].counters[Counter.TOKENS])
    check(tokens == MOE_TRAIN_STEPS * T,
          f"moe-train: ledger TOKENS {tokens} == {MOE_TRAIN_STEPS} steps x "
          f"{TRAIN_BATCH} x {TRAIN_SEQ - 1}")
    losses = [float(m["loss"]) for m in metrics]
    drops = [float(m["moe_drop_frac"]) for m in metrics]
    auxes = [float(m["aux_loss"]) for m in metrics]
    print(f"  moe-train: losses {[round(x, 4) for x in losses]}, aux "
          f"{[round(x, 4) for x in auxes]}, moe_drop_frac "
          f"{[round(x, 4) for x in drops]}", flush=True)
    check(len(losses) == MOE_TRAIN_STEPS
          and all(math.isfinite(x) for x in losses + auxes),
          f"moe-train: {len(losses)} losses and aux losses, all finite")
    check(all(0.0 <= x < 1.0 for x in drops),
          f"moe-train: moe_drop_frac {drops} in [0, 1)")
    moved = {"embed": max_abs(params["embed"][:8], watch["embed"]),
             "router": max_abs(params["layers"]["router"][0],
                               watch["router"]),
             "we1": max_abs(params["layers"]["we1"][0, 0, :8], watch["we1"]),
             "head": max_abs(params["head"][:, :8], watch["head"])}
    check(all(x > 0 for x in moved.values()),
          f"moe-train: params moved (max |delta| {moved})")
    st = eng.stats()
    ctx = jobs["moe-serve"].contexts[0]
    served = int(ctx.counters[Counter.TOKENS])
    check(st["completed"] == len(reqs) == jobs["moe-serve"].state["completed"]
          and not eng.has_work(),
          f"moe-serve: {st['completed']} of {len(reqs)} requests completed "
          f"in the {n_ticks} ticks the script needs")
    check(served == eng.tokens_emitted == sum(budgets),
          f"moe-serve: ledger TOKENS {served} == tokens_emitted "
          f"{eng.tokens_emitted} == the budgets' sum {sum(budgets)}")
    check(st["mlp_extra_mean"] == 0.0,
          f"moe-serve: mlp_extra_mean {st['mlp_extra_mean']} == 0.0 "
          f"(dropless: no token dropped)")
    L = tcfg.n_layers
    derive = {"flash_fwd": (2 * L * MOE_TRAIN_STEPS,
                            f"{L} layers x {MOE_TRAIN_STEPS} steps x 2 "
                            f"(forward + recompute under full remat)"),
              "flash_bwd_dq": (L * MOE_TRAIN_STEPS,
                               f"{L} layers x {MOE_TRAIN_STEPS} steps"),
              "flash_bwd_dkv": (L * MOE_TRAIN_STEPS,
                                f"{L} layers x {MOE_TRAIN_STEPS} steps"),
              "instrumented_matmul": (0, "no matmul tenant; the expert "
                                         "products are einsums")}
    for name, (want, how) in derive.items():
        n = launches[name]
        check(n == want and routes[name] == {"wgmma": n, "simt": 0},
              f"{name}: {n} launches == {want} = {how}, every one on the "
              f"tensor-core route ({routes[name]}); the engine launches none")
    ms_train = (int(train.contexts[0].counters[Counter.DEVICE_TIME_NS]) / 1e6
                / MOE_TRAIN_STEPS)
    ms_eng = int(ctx.counters[Counter.DEVICE_TIME_NS]) / 1e6
    print(f"  moe-train: {ms_train:.2f} ms per step (ledger device time / "
          f"{MOE_TRAIN_STEPS}) [{card}]", flush=True)
    print(engine_line(
        "(a) bf16 dropless MoE engine (tenant)", eng, wall,
        decode_tick_ms(ticks), time_prefill(torch, eng, reqs[0][0]),
        serve_ms_per_token, card,
        f"; ledger {ms_eng / n_ticks:.2f} ms per tick, "
        f"{ms_eng / served:.3f} ms per token"), flush=True)
    del eng, sparams
    print(f"  (a) wall {time.monotonic() - t_phase:.1f} s", flush=True)

    # (b) an fp32 dropless engine, token-exact against make_moe_generate
    def fwd(cfg, p, tokens, cache):
        return moe_forward_with_cache(cfg, p, tokens, cache)

    first = {i: reqs[i] for i in range(ENGINE_FIRST)}
    first_arrivals = {0: list(first)}
    plain = ContinuousBatcher(cfg32, master, mlp_fn=moe_slot_mlp(cfg32), **kw)
    b = drive_engine(torch, plain, reqs, first_arrivals)
    b_toks = {i: c.tokens for i, c in b["done"].items()}
    check(sorted(b_toks) == list(first)
          and all(len(b_toks[i]) == reqs[i][1] for i in first)
          and plain.stats()["mlp_extra_mean"] == 0.0,
          f"(b) fp32 MoE engine: {len(b_toks)} requests, each with its "
          f"budget, mlp_extra_mean 0.0")
    want, drops = {}, []
    for i, (prompt, n) in first.items():
        out, drop = make_moe_generate(cfg32, n)(
            master, torch.tensor(prompt[None], device="cuda"))
        want[i] = out[0].tolist()
        drops.append(float(drop))
    check(all(x == 0.0 for x in drops),
          f"(b) lockstep make_moe_generate: drop fraction 0.0 on all "
          f"{len(drops)} requests (dropless): {drops}")
    ties = compare_tokens(torch, cfg32, master, reqs, b_toks, want,
                          "(b) fp32 MoE engine vs lockstep "
                          "make_moe_generate (B=1)", fwd)
    print(f"  (b) fp32 MoE engine token-exact against the lockstep generate "
          f"on {len(want) - len(ties)} of {len(want)} requests, the rest "
          f"near-ties {ties}", flush=True)
    print(engine_line("(b) fp32 dropless MoE engine", plain, b["wall"],
                      decode_tick_ms(b["ticks"]),
                      time_prefill(torch, plain, reqs[0][0]),
                      serve_ms_per_token, card), flush=True)
    b_steps = plain.stats()["steps"]
    del plain

    # (c) the speculative engine, MoE target and MoE noisy-head draft
    head = master["head"]
    noise = torch.randn(head.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(MOE_SEED + 2))
    draft = dict(master, head=head + ENGINE_DRAFT_NOISE * head.std() * noise)
    spec = SpeculativeBatcher(cfg32, master, cfg32, draft, k=ENGINE_K,
                              mlp_fn=moe_slot_mlp(cfg32),
                              draft_mlp_fn=moe_slot_mlp(cfg32), **kw)
    c = drive_engine(torch, spec, reqs, first_arrivals)
    c_toks = {i: r.tokens for i, r in c["done"].items()}
    check(sorted(c_toks) == list(first),
          f"(c) speculative MoE engine: {len(c_toks)} requests completed")
    spec_ties = compare_tokens(torch, cfg32, master, reqs, c_toks, b_toks,
                               "(c) speculative MoE vs (b)'s engine", fwd)
    sst = spec.stats()
    check(sst["steps"] < b_steps and sst["mlp_extra_mean"] == 0.0
          and sst["draft_mlp_extra_mean"] == 0.0,
          f"(c) speculative MoE engine: {sst['steps']} ticks < (b)'s "
          f"{b_steps}; target and draft drop nothing")
    print(engine_line("(c) fp32 speculative MoE engine, k=4", spec,
                      c["wall"], decode_tick_ms(c["ticks"]),
                      time_prefill(torch, spec, reqs[0][0]),
                      serve_ms_per_token, card,
                      f"; spec_acceptance {sst['spec_acceptance']} "
                      f"({sst['spec_accepted']} of {sst['spec_proposed']}); "
                      f"near-ties {spec_ties}"), flush=True)
    del spec, draft, noise
    print(f"  phase 3e wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, routes, train_step, train.state, master


# -- phase 3c ----------------------------------------------------------------


def control_engine(torch, cfg, params, reqs, arrivals, n_ticks):
    """A bf16 engine on 3s's script as the Job ``engine`` (one tick a
    step), recording each tick's host ms and admissions."""
    from pbs_tpu_torch.models import (ContinuousBatcher,
                                      make_continuous_serve_step)
    from pbs_tpu_torch.runtime import Job, SchedParams

    eng = ContinuousBatcher(cfg, params, n_slots=ENGINE_SLOTS,
                            prompt_bucket=ENGINE_BUCKET,
                            max_len=ENGINE_MAX_LEN,
                            prefix_cache_size=ENGINE_PREFIX)
    serve_step = make_continuous_serve_step(
        eng, next_requests=lambda t: [reqs[i] for i in arrivals.get(t, [])])
    ticks = []

    def engine_fn(state):
        t = time.monotonic()
        out = serve_step(state)
        ticks.append(((time.monotonic() - t) * 1e3, len(eng._admitted)))
        return out

    job = Job("engine", step_fn=engine_fn, state={"step": 0, "completed": 0},
              params=SchedParams(weight=CONTROL_WEIGHTS["engine"],
                                 tslice_us=100, boost_on_wake=True),
              max_steps=n_ticks)
    return eng, job, ticks


def control_tenants(torch, gen, cfg, params, reqs, arrivals, n_ticks):
    """Fresh Jobs for score, mm and the engine (3s's weights), in that
    order, and the engine with its tick record."""
    from pbs_tpu_torch.runtime import Job, SchedParams

    jobs = {}
    for name, fn in (("score", scoring_tenant(torch, gen, cfg, params)),
                     ("mm", mm_tenant(torch, gen))):
        fn(None)  # warm outside the partition
        jobs[name] = Job(name, step_fn=fn,
                         params=SchedParams(weight=CONTROL_WEIGHTS[name]),
                         max_steps=STEPS[name])
    eng, jobs["engine"], ticks = control_engine(torch, cfg, params, reqs,
                                                arrivals, n_ticks)
    torch.cuda.synchronize()
    return jobs, eng, ticks


def control_launches(wrappers) -> tuple[dict, dict]:
    return (dict(zip(KERNELS, (w.launches for w in wrappers))),
            dict(zip(KERNELS, (dict(w.launches_by_route)
                               for w in wrappers))))


def check_control_run(what, part, jobs, eng, reqs, launches, routes,
                      want_kernels) -> None:
    """Every job retired its steps with no fault, its ledger words are
    its counters, every request was served, and the kernels this run
    names launched, all on the tensor-core route (the others not)."""
    from pbs_tpu_torch.telemetry import Counter

    for name, job in jobs.items():
        check(job.error is None and job.steps_retired() == job.max_steps,
              f"({what}) {name}: {job.steps_retired()} of {job.max_steps} "
              f"steps retired, no fault ({job.error})")
        ctx = job.contexts[0]
        check(part.ledger.snapshot(ctx.ledger_slot).tolist()
              == ctx.counters.tolist(),
              f"({what}) {name}: ledger snapshot equals the context "
              f"counters")
    if eng is not None:
        st = eng.stats()
        budgets = sum(n for _, n in reqs)
        tokens = int(jobs["engine"].contexts[0].counters[Counter.TOKENS])
        check(st["completed"] == len(reqs)
              == jobs["engine"].state["completed"] and not eng.has_work()
              and tokens == eng.tokens_emitted == budgets,
              f"({what}) engine: {st['completed']} of {len(reqs)} requests "
              f"served, ledger TOKENS {tokens} == the budgets' sum "
              f"{budgets}")
    for name in KERNELS:
        n = launches[name]
        if name in want_kernels:
            check(n > 0 and routes[name] == {"wgmma": n, "simt": 0},
                  f"({what}) {name}: {n} launches, every one on the "
                  f"tensor-core route ({routes[name]})")
        else:
            check(n == 0, f"({what}) {name}: {n} launches == 0")


def shares(jobs, wall_s, weights) -> str:
    """Each tenant's device time over the run's wall time, and its
    device share over its weight share."""
    from pbs_tpu_torch.telemetry import Counter

    dev = {n: int(j.contexts[0].counters[Counter.DEVICE_TIME_NS]) / 1e9
           for n, j in jobs.items()}
    total_dev, total_w = sum(dev.values()), sum(weights.values())
    return ", ".join(
        f"{n} {dev[n]:.3f} s ({dev[n] / wall_s:.3f} of wall; device share "
        f"{dev[n] / total_dev:.3f} / weight share "
        f"{weights[n] / total_w:.3f} = "
        f"{(dev[n] / total_dev) / (weights[n] / total_w):.3f})"
        for n in jobs)


def arinc_windows(frame) -> list:
    """(start_ns, end_ns, owner) of each window in one major frame."""
    out, t = [], 0
    for name, dur_us in frame:
        out.append((t, t + dur_us * 1000, name))
        t += dur_us * 1000
    return out


def check_arinc_picks(part, sched, jobs, frame) -> dict:
    """From the partition's trace rings: every SCHED_PICK of a job lies
    in one of its own windows (or at most CONTROL_PICK_SLACK_NS past its
    end: the record is written after the decision), measured from the
    first frame's start; and each quantum's overrun (ran - granted) per
    job, from the SCHED_PICK/SCHED_DESCHED pairs."""
    from pbs_tpu_torch.obs.trace import Ev

    frame_ns = sum(d for _, d in frame) * 1000
    frame0 = sched.frame_start_ns - sched.frame_count * frame_ns
    windows = arinc_windows(frame)
    by_slot = {j.contexts[0].ledger_slot: n for n, j in jobs.items()}
    recs = part.drain_traces().tolist()
    picks, late, max_late, overrun = 0, 0, 0, {n: 0 for n in jobs}
    open_pick = None
    for ts, ev, slot, arg, *_ in recs:
        if ev == int(Ev.SCHED_PICK):
            name = by_slot[slot]
            off = (ts - frame0) % frame_ns
            owner = next(o for s, e, o in windows if s <= off < e)
            if owner != name:
                prev = [e for s, e, o in windows if o == name and e <= off]
                lateness = off - max(prev) if prev else frame_ns
                check(lateness <= CONTROL_PICK_SLACK_NS,
                      f"(c) {name}: a pick {off / 1e6:.3f} ms into a frame "
                      f"lies in {owner}'s window, {lateness / 1e3:.1f} us "
                      f"past its own")
                late += 1
                max_late = max(max_late, lateness)
            picks += 1
            open_pick = (name, arg)
        elif ev == int(Ev.SCHED_DESCHED) and open_pick is not None:
            name, granted = open_pick
            overrun[name] += max(0, arg - granted)
            open_pick = None
    check(picks == sum(j.contexts[0].sched_count for j in jobs.values()),
          f"(c) {picks} SCHED_PICK records, one per dispatch, every one in "
          f"its tenant's own window ({late} up to {max_late / 1e3:.1f} us "
          f"late, the record after its decision)")
    return overrun


def control_sleep_cycles(torch) -> float:
    """The card's ``torch.cuda._sleep`` cycles per second, measured."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 200_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / (start.elapsed_time(end) / 1e3)


def run_control_path(torch, gen, cfg, params, card):
    """Phase 3c: (a) credit2 on two lanes of the card, (b) SEDF with a
    reservation for the engine and the training tenant in extra time,
    (c) ARINC 653 in an explicit major frame, (d) credit under the ATC
    policy and under the tuned "serving" profile with live knob pushes,
    (e) xsm, hooks, the wall watchdog, a crash dump and the ledger file.
    Returns the launch counts and routes summed over (a)-(c)."""
    import shutil

    from pbs_tpu_torch import knobs
    from pbs_tpu_torch.knobs.channel import KnobChannel, KnobWatcher
    from pbs_tpu_torch.obs.trace import Ev
    from pbs_tpu_torch.runtime import (HookError, Job, LabelPolicy,
                                       MemoryManager, Partition, SchedParams,
                                       WallWatchdog, XsmDenied,
                                       install_crash_handler, xsm)
    from pbs_tpu_torch.sched import AtcFeedbackPolicy, FeedbackPolicy
    from pbs_tpu_torch.sched.atc import (ATC_MAX_US, ATC_MIN_US,
                                         SLICE_BASE_US, SLICE_STEP_US)
    from pbs_tpu_torch.sched.tune import policy_from_profile
    from pbs_tpu_torch.telemetry import Counter, CudaBackend, Ledger

    t_phase = time.monotonic()
    reqs, arrivals = engine_script()
    n_ticks = engine_ticks([n for _, n in reqs], arrivals, ENGINE_SLOTS)
    wrappers = bwd_counts()
    total = {k: 0 for k in KERNELS}
    total_routes = {k: {"wgmma": 0, "simt": 0} for k in KERNELS}

    def counted(what, part, jobs, eng, want):
        reset_counts(wrappers)
        t0 = time.monotonic()
        quanta = part.run()
        wall = time.monotonic() - t0
        launches, routes = control_launches(wrappers)
        for k in KERNELS:
            total[k] += launches[k]
            for r, n in routes[k].items():
                total_routes[k][r] += n
        print(f"  ({what}) {quanta} quanta in {wall:.2f} s wall; kernel "
              f"launches {launches}, by route {routes}", flush=True)
        print_tenants(jobs, Counter)
        check_control_run(what, part, jobs, eng, reqs, launches, routes,
                          want)
        return wall

    def engine_summary(what, eng, ticks, wall):
        st = eng.stats()
        print(f"  ({what}) engine: TTFT p50 {st['ttft_p50_s'] * 1e3:.2f} / "
              f"p99 {st['ttft_p99_s'] * 1e3:.2f} ms, latency p50 "
              f"{st['latency_p50_s'] * 1e3:.2f} / p99 "
              f"{st['latency_p99_s'] * 1e3:.2f} ms (host clock); decode "
              f"tick {decode_tick_ms(ticks):.2f} ms (median) over "
              f"{st['steps']} ticks in {wall:.2f} s [{card}]", flush=True)

    # (a) credit2: two lanes on the card in two runqueues
    jobs, eng, ticks = control_tenants(torch, gen, cfg, params, reqs,
                                       arrivals, n_ticks)
    lane = torch.device("cuda", 0)
    part = Partition("control-a", source=CudaBackend(), scheduler="credit2",
                     devices=[lane, lane],
                     sched_params={"executors_per_runq": 1})
    check_native(part)
    fb = FeedbackPolicy(part)
    for job in jobs.values():
        part.add_job(job)
    wall = counted("a", part, jobs, eng, ("flash_fwd", "instrumented_matmul"))
    st = part.scheduler.dump_settings()
    print(f"  (a) credit2 settings {json.dumps(st)}")
    for ex in part.executors:
        print(f"  (a) lane {ex.index} (dispatches {ex.dispatch_count}): "
              f"{json.dumps(part.scheduler.dump_executor(ex))}")
    print(f"  (a) tickles {st['tickles']}, migrations {st['migrations']}; "
          f"feedback {json.dumps(fb.dump())}")
    print(f"  (a) {shares(jobs, wall, CONTROL_WEIGHTS)} [{card}]")
    check(all(ex.dispatch_count > 0 for ex in part.executors),
          f"(a) both lanes dispatched "
          f"({[ex.dispatch_count for ex in part.executors]})")
    engine_summary("a", eng, ticks, wall)
    del jobs, eng, part

    # (b) SEDF: a reservation for the engine, training in extra time
    eng, ejob, ticks = control_engine(torch, cfg, params, reqs, arrivals,
                                      n_ticks)
    tenant = training_tenant(torch, gen, CONTROL_TRAIN_STEPS)
    from pbs_tpu_torch.models.transformer import loss_and_grads

    loss_and_grads(tenant["cfg"], tenant["params"], tenant["spare"])
    torch.cuda.synchronize()
    train = Job("train", micro_step_fn=tenant["train_fn"],
                micro_per_step=TRAIN_MICRO,
                state=tenant["init_state"](tenant["params"]),
                params=SchedParams(weight=512, tslice_us=100),
                max_steps=CONTROL_TRAIN_STEPS)
    jobs = {"engine": ejob, "train": train}
    part = Partition("control-b", source=CudaBackend(), scheduler="sedf")
    check_native(part)
    for job in jobs.values():
        part.add_job(job)
    part.scheduler.set_reservation(
        ejob, period_us=CONTROL_SEDF_PERIOD_US,
        slice_us=CONTROL_SEDF_SLICE_US,
        latency_us=CONTROL_SEDF_LATENCY_US, extratime=True)
    wall = counted("b", part, jobs, eng,
                   ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    rows = {r["ctx"]: r for r in
            part.scheduler.dump_executor(part.executors[0])["contexts"]}
    picks = part.drain_traces().tolist()
    train_picks = sum(1 for r in picks if r[1] == int(Ev.SCHED_PICK)
                      and r[2] == train.contexts[0].ledger_slot)
    for name, r in rows.items():
        print(f"  (b) {name}: period {r['period_us']} us, slice "
              f"{r['slice_us']} us, deadline misses {r['deadline_misses']}, "
              f"extra time {r['extra_time_ms']} ms, blocks {r['blocks']}")
    print(f"  (b) penalty queue: {rows['engine/0']['blocks']['pen_slices']} "
          f"slices of engine; train dispatches: {train_picks}; "
          f"micro-step losses "
          f"{[round(float(x), 4) for x in tenant['losses']]}")
    print(f"  (b) {shares(jobs, wall, {'engine': 1, 'train': 1})} [{card}]")
    check(all(math.isfinite(float(x)) for x in tenant["losses"])
          and len(tenant["losses"]) == CONTROL_TRAIN_STEPS * TRAIN_MICRO,
          f"(b) train: {len(tenant['losses'])} finite micro-step losses")
    engine_summary("b", eng, ticks, wall)
    del jobs, eng, part, train, tenant

    # (c) ARINC 653: an explicit major frame
    jobs, eng, ticks = control_tenants(torch, gen, cfg, params, reqs,
                                       arrivals, n_ticks)
    part = Partition("control-c", source=CudaBackend(), scheduler="arinc653")
    check_native(part)
    for job in jobs.values():
        part.add_job(job)
    sched = part.scheduler
    sched.set_schedule(CONTROL_FRAME)
    # Every change to a tenant's debt, with the window it happened in.
    repaid = {n: 0 for n in jobs}
    foreign = []
    decide = sched.do_schedule

    def do_schedule(ex, now_ns):
        before = dict(sched.overrun_ns)
        decision = decide(ex, now_ns)
        _, owner, _ = sched._slot_at(now_ns)
        for name, debt in before.items():
            paid = debt - sched.overrun_ns.get(name, 0)
            if paid > 0:
                repaid[name] += paid
                if owner != name:
                    foreign.append((name, owner, paid))
        return decision

    sched.do_schedule = do_schedule
    wall = counted("c", part, jobs, eng, ("flash_fwd", "instrumented_matmul"))
    overrun = check_arinc_picks(part, sched, jobs, CONTROL_FRAME)
    st = sched.dump_settings()
    print(f"  (c) {st['frames']} frames of {st['major_frame_us']} us; slots "
          f"{json.dumps(st['slots'])}")
    print(f"  (c) overruns from the rings (ns) {overrun}; repaid in own "
          f"windows {repaid}; debt left {st['overrun_ns']}")
    frame_us = st["major_frame_us"]
    window = {n: sum(d for o, d in CONTROL_FRAME if o == n) / frame_us
              for n in jobs}
    dev = {n: int(j.contexts[0].counters[Counter.DEVICE_TIME_NS]) / 1e9
           for n, j in jobs.items()}
    print("  (c) device share of wall against window share: " + ", ".join(
        f"{n} {dev[n] / wall:.3f} / {window[n]:.3f}" for n in jobs)
        + f" [{card}]")
    check(not foreign, f"(c) no overrun repaid from another tenant's "
                       f"window ({foreign})")
    check(all(overrun[n] == repaid[n] + st["overrun_ns"][n] for n in jobs),
          "(c) every overrun on the rings is repaid in its tenant's own "
          "windows or still owed")
    engine_summary("c", eng, ticks, wall)
    del jobs, eng, part, sched

    # (d) credit under the ATC policy, then the tuned "serving" profile
    # with live knob pushes
    jobs, eng, ticks = control_tenants(torch, gen, cfg, params, reqs,
                                       arrivals, n_ticks)
    part = Partition("control-d-atc", source=CudaBackend(),
                     scheduler="credit")
    check_native(part)
    atc = AtcFeedbackPolicy(part)
    for job in jobs.values():
        part.add_job(job)
    t0 = time.monotonic()
    part.run()
    wall = time.monotonic() - t0
    rows = atc.dump()
    print(f"  (d) ATC: {json.dumps(rows)} in {wall:.2f} s")
    # One card has no collective wait, so every contention sample is 0:
    # the EWMA stays 0, the bucket is 0 once HISTORY samples agree (a
    # job with fewer samples has none yet), and the law's slice at
    # bucket 0, min(ATC_MAX_US, SLICE_BASE_US), replaces every job's
    # starting slice through the global minimum.
    law0 = max(ATC_MIN_US, min(ATC_MAX_US, SLICE_BASE_US - SLICE_STEP_US * 0))
    check(all(j.error is None and j.steps_retired() == j.max_steps
              for j in jobs.values()),
          "(d) ATC: every job retired its steps")
    check(law0 == ATC_MAX_US and all(r["tslice_us"] == law0 for r in rows)
          and all(r["ewma_ns"] == 0.0 for r in rows)
          and all(r["bucket"] in (0, None) for r in rows)
          and any(r["bucket"] == 0 for r in rows),
          f"(d) ATC: every EWMA 0, every applied bucket 0, every slice the "
          f"law's {law0} us at bucket 0 (from "
          f"{SchedParams().tslice_us} us)")
    engine_summary("d atc", eng, ticks, wall)
    del jobs, eng, part

    tmp, _ = paging_dir("3c")
    try:
        jobs, eng, ticks = control_tenants(torch, gen, cfg, params, reqs,
                                           arrivals, n_ticks)
        part = Partition("control-d", source=CudaBackend(),
                         scheduler="credit")
        check_native(part)
        fb = policy_from_profile(part, "serving")
        band0 = (fb.min_us, fb.max_us)
        path = os.path.join(tmp, "knobs.led")
        writer = KnobChannel.create(path)
        watcher = KnobWatcher(KnobChannel.attach(path))
        applied = []

        def apply(changed, _values):
            applied.append((part.clock.now_ns(), fb.apply_knobs(changed)))

        watcher.add(apply)
        part.timers.arm(part.clock.now_ns() + 1_000_000,
                        lambda now: watcher.poll(), period_ns=1_000_000,
                        name="knob_watch")
        for job in jobs.values():
            part.add_job(job)
        t0 = time.monotonic()
        part.run(until_ns=part.clock.now_ns() + CONTROL_PUSH_AFTER_NS)
        gen_push = writer.push(
            {"sched.feedback.tslice_max_us": CONTROL_PUSH_MAX_US})
        part.run()
        wall = time.monotonic() - t0
        recs = part.drain_traces().tolist()
        check(applied and applied[0][1] == {"max_us": CONTROL_PUSH_MAX_US}
              and (fb.min_us, fb.max_us) == (band0[0], CONTROL_PUSH_MAX_US),
              f"(d) the push (generation {gen_push}) applied mid-run: band "
              f"{band0} -> ({fb.min_us}, {fb.max_us})")
        t_apply = applied[0][0]
        before = [r[3] // 1000 for r in recs
                  if r[1] == int(Ev.SCHED_PICK) and r[0] < t_apply]
        after = [r[3] // 1000 for r in recs
                 if r[1] == int(Ev.SCHED_PICK) and r[0] >= t_apply]
        check(after and all(fb.min_us <= q <= fb.max_us for q in after)
              and all(fb.min_us <= j.params.tslice_us <= fb.max_us
                      for j in jobs.values()),
              f"(d) every quantum after the push in the new band: "
              f"{len(after)} picks, {min(after)}-{max(after)} us (before: "
              f"{len(before)} picks, {min(before, default=0)}-"
              f"{max(before, default=0)} us)")
        for name, job in jobs.items():
            check(job.error is None and job.steps_retired() == job.max_steps,
                  f"(d) {name}: {job.steps_retired()} steps retired")
        # an inverted band is refused whole, by the channel and the policy
        raw = open(path, "rb").read()
        view = (fb.min_us, fb.max_us, fb.window_len)
        refused = []
        for push in (lambda: writer.push(
                {"sched.feedback.tslice_min_us": 600,
                 "sched.feedback.tslice_max_us": 200}),
                lambda: fb.apply_knobs(
                    {"sched.feedback.tslice_min_us": 600,
                     "sched.feedback.tslice_max_us": 200})):
            try:
                push()
            except knobs.KnobError as e:
                refused.append(str(e))
        check(len(refused) == 2 and open(path, "rb").read() == raw
              and watcher.poll() is None
              and (fb.min_us, fb.max_us, fb.window_len) == view,
              f"(d) an inverted band refused whole by the channel and by "
              f"the policy ({refused})")
        engine_summary("d profile", eng, ticks, wall)
        del jobs, eng, part
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) xsm, hooks, the wall watchdog, a crash dump, the ledger file
    tmp, _ = paging_dir("3c")
    try:
        mem = MemoryManager.for_device()
        part = Partition("control-e", source=CudaBackend(), memory=mem,
                         ledger_path=os.path.join(tmp, "ledger"),
                         trace_dir=os.path.join(tmp, "traces"))
        check_native(part)
        install_crash_handler(part, os.path.join(tmp, "crash"))
        part.hooks.on("job-add", lambda ev, env: 1 / 0)  # optional
        part.hooks.on("job-add", lambda ev, env: (_ for _ in ()).throw(
            RuntimeError("no dataset mount"))
            if env["PBST_JOB"] == "vetoed" else None, required=True)
        mm_fn = mm_tenant(torch, gen)
        free0 = sorted(part._free_slots)
        xsm.set_policy(LabelPolicy(default_allow=True)
                       .deny("tenant", "job.create", "restricted"))
        try:
            try:
                part.add_job(Job("denied", step_fn=mm_fn, max_steps=1,
                                 label="restricted", mem_bytes=1 << 30),
                             subject="tenant")
                denied = None
            except XsmDenied as e:
                denied = str(e)
        finally:
            xsm.set_policy(xsm.DummyPolicy())
        check(denied is not None and "denied" not in mem.dump()["accounts"]
              and sorted(part._free_slots) == free0,
              f"(e) xsm: {denied}; no HBM claim, no ledger slot taken")
        try:
            part.add_job(Job("vetoed", step_fn=mm_fn, max_steps=1,
                             mem_bytes=1 << 30))
            vetoed = None
        except HookError as e:
            vetoed = str(e)
        meta = json.load(open(os.path.join(tmp, "ledger.meta.json")))
        check(vetoed is not None and "vetoed" not in mem.dump()["accounts"]
              and sorted(part._free_slots) == free0 and not meta["slots"],
              f"(e) a required job-add hook failing unwinds the admission "
              f"({vetoed}); the sidecar names no slot")
        hz = control_sleep_cycles(torch)
        steps = [0]

        def hold_fn(state):
            torch.cuda._sleep(int(CONTROL_HOLD_S * hz))
            torch.cuda.synchronize()
            return state

        def flaky_fn(state):
            steps[0] += 1
            if steps[0] == 2:
                raise RuntimeError("tenant fault at its second step")
            return mm_fn(state)

        jobs = {"mm": Job("mm", step_fn=mm_fn, max_steps=STEPS["mm"],
                          mem_bytes=1 << 28),
                "hold": Job("hold", step_fn=hold_fn, max_steps=1),
                "flaky": Job("flaky", step_fn=flaky_fn, max_steps=4)}
        for job in jobs.values():
            part.add_job(job)
        check(part.hooks.failures == 2 + len(jobs),
              f"(e) optional hook failures counted: {part.hooks.failures} "
              f"({json.dumps(part.hooks.dump())})")
        barks = []
        wd = WallWatchdog(part, timeout_s=CONTROL_WATCHDOG_S, poll_s=0.05,
                          on_bark=lambda p, idle: barks.append(idle))
        t0 = time.monotonic()
        with wd:
            part.run()
        wall = time.monotonic() - t0
        check(wd.barks == 1 and len(barks) == 1
              and barks[0] >= CONTROL_WATCHDOG_S,
              f"(e) the wall watchdog barked {wd.barks} time(s) at "
              f"{[round(b, 3) for b in barks]} s idle, a "
              f"{CONTROL_HOLD_S:.0f} s hold of the card "
              f"({hz / 1e9:.3f} G sleep cycles/s), run {wall:.2f} s")
        dumps = os.listdir(os.path.join(tmp, "crash"))
        doc = json.load(open(os.path.join(tmp, "crash", dumps[0]))) \
            if len(dumps) == 1 else {}
        tail = doc.get("trace_tail", [])
        check(len(dumps) == 1 and doc.get("failed_job") == "flaky"
              and doc["partition"]["scheduler"]["name"] == "credit"
              and any(j["job"] == "mm" and j["contexts"][0]["counters"]
                      for j in doc["jobs"])
              and any("SCHED_PICK" in ln for ln in tail)
              and any("SCHED_DESCHED" in ln for ln in tail),
              f"(e) one crash dump for flaky ({dumps}): keys "
              f"{sorted(doc)}, {len(tail)} trace lines")
        mon = Ledger.file_backed(os.path.join(tmp, "ledger"), readonly=True,
                                 native=True)
        check(all(mon.snapshot(j.contexts[0].ledger_slot).tolist()
                  == j.contexts[0].counters.tolist() for j in jobs.values()),
              "(e) a read-only attach of the ledger file reads the "
              "contexts' counters word for word")
        check(jobs["mm"].steps_retired() == STEPS["mm"]
              and jobs["hold"].steps_retired() == 1
              and jobs["flaky"].error is not None,
              "(e) mm and hold retired their steps beside the contained "
              "fault")
        del part, jobs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in KERNELS:
        check(total[k] > 0 and total_routes[k] == {"wgmma": total[k],
                                                   "simt": 0},
              f"{k}: {total[k]} launches over (a)-(c), every one on the "
              f"tensor-core route ({total_routes[k]})")
    print(f"  phase 3c wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return total, total_routes


# -- phase 3r ----------------------------------------------------------------


def own_delta_backend(device):
    """A ``CudaBackend`` on ``device`` that also sums, per job, the counter
    deltas it returns (``own_totals``), before ``HwCounterSource``
    overlays its host tier's slots into the same array
    (``hwtelem/sources.py``, ``_overlay``). On the card a task-clock tier
    puts the host process's CPU time where ``CudaBackend``'s device time
    was; this keeps the card's own numbers beside it."""
    from pbs_tpu_torch.telemetry import CudaBackend

    class OwnDeltaBackend(CudaBackend):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.own_totals: dict = {}

        def _keep(self, ctx, deltas):
            total = self.own_totals.get(ctx.job.name)
            if total is None:
                total = self.own_totals[ctx.job.name] = deltas * 0
            total += deltas
            return deltas

        def execute(self, ctx, n_steps):
            return self._keep(ctx, super().execute(ctx, n_steps))

        def execute_micro(self, ctx, n_micro):
            return self._keep(ctx, super().execute_micro(ctx, n_micro))

    return OwnDeltaBackend(device=device)


def record_run(what, make_tenants, device, make_tier, path, policy_for,
               counted):
    """One live run of phase 3r: the tenants in a credit Partition whose
    source is ``HwCounterSource`` over a ``CudaBackend`` on ``device``
    (:func:`own_delta_backend`), steered by
    ``policy_for(part, source)``, with the run recorder writing ``path``;
    a second ``HwCounterSource`` with no inner is sampled into an
    ``HwRecorder`` once per ``part.run(max_rounds=1)`` round. Checks one
    ``quantum`` record per dispatched quantum (against the trace ring's
    SCHED_DESCHED records and each context's dispatches), ``tick``
    records that account for every grow, shrink and reset the policy
    counted (``policy.dump()``) and number no more than its metric ticks,
    each job's recorded deltas summing to
    its ledger words bit for bit, every step retired and every request
    served. ``counted(what)`` is entered just before the first round and
    left just after the last."""
    import numpy as np

    from pbs_tpu_torch.hwtelem import HwCounterSource, HwRecorder
    from pbs_tpu_torch.obs.trace import Ev
    from pbs_tpu_torch.runtime import Partition
    from pbs_tpu_torch.sim import TraceRecorder
    from pbs_tpu_torch.telemetry import Counter
    from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS

    jobs, eng, ticks = make_tenants()
    start = {n: dict(weight=j.params.weight, cap=j.params.cap,
                     tslice_us=j.params.tslice_us,
                     boost_on_wake=j.params.boost_on_wake)
             for n, j in jobs.items()}
    inner = own_delta_backend(device)
    src = HwCounterSource(inner=inner, tier=make_tier())
    feed = HwCounterSource(tier=make_tier())
    part = Partition(f"record-{what}", source=src, scheduler="credit")
    check_native(part)
    policy = policy_for(part, src)
    for job in jobs.values():
        part.add_job(job)
    rec = TraceRecorder(path)
    rec.meta(scheduler="credit", n_executors=1, source=src.describe(),
             jobs=[{"name": n, "weight": j.params.weight,
                    "cap": j.params.cap, "tslice_us": j.params.tslice_us,
                    "n_contexts": len(j.contexts),
                    "avg_step_ns": int(j.contexts[0].avg_step_ns)}
                   for n, j in jobs.items()])
    part.recorder = rec
    window = HwRecorder(tier=feed.tier.name if feed.tier is not None
                        else "none", capacity=RECORD_WINDOW_CAPACITY)
    feed.sample()  # the baseline: sample 0 charges the first round
    rounds = quanta = 0
    with counted(what):
        t0 = time.monotonic()
        while rounds < RECORD_MAX_ROUNDS:
            n = part.run(max_rounds=1)
            rounds, quanta = rounds + 1, quanta + n
            window.sample(feed.clock.now_ns(), feed.sample())
            if n == 0 and not part.pending_work():
                break
        wall = time.monotonic() - t0
    rec.close()
    policy.timer.stop()
    src.close()
    feed.close()
    recs = rec.records()
    by_slot = {j.contexts[0].ledger_slot: n for n, j in jobs.items()}
    desched = {n: 0 for n in jobs}
    for r in part.drain_traces().tolist():
        if r[1] == int(Ev.SCHED_DESCHED):
            desched[by_slot[r[2]]] += 1
    check(not part.pending_work() and sum(desched.values()) == quanta,
          f"({what}) the run drained in {rounds} rounds: {quanta} quanta, "
          f"{sum(desched.values())} SCHED_DESCHED records on the ring")
    print(f"  ({what}) {quanta} quanta in {wall:.2f} s wall, "
          f"{len(recs)} trace records; window: {len(window.window().samples)}"
          f" samples from the {window.tier} tier, {window.dropped} dropped")
    print(f"  {'tenant':<6} {'steps':>5} {'quanta':>6} {'ticks':>5} "
          f"{'device_ms(card)':>15} {'device_ms(hw)':>13} "
          f"{'stall_ms(card)':>14} {'stall_ms(hw)':>12} {'tslice_us':>9}")
    for n, job in jobs.items():
        ctx = job.contexts[0]
        qrecs = [r for r in recs if r["kind"] == "quantum" and r["job"] == n]
        trecs = [r for r in recs if r["kind"] == "tick" and r["job"] == n]
        n_ticks = len(trecs)
        sums = np.zeros(NUM_COUNTERS, dtype=np.uint64)
        for r in qrecs:
            for k, v in r["c"].items():
                sums[Counter[k.upper()]] += np.uint64(v)
        mine = inner.own_totals[n]
        print(f"  {n:<6} {job.steps_retired():>5} {len(qrecs):>6} "
              f"{n_ticks:>5} "
              f"{int(mine[Counter.DEVICE_TIME_NS]) / 1e6:>15.3f} "
              f"{int(ctx.counters[Counter.DEVICE_TIME_NS]) / 1e6:>13.3f} "
              f"{int(mine[Counter.HBM_STALL_NS]) / 1e6:>14.3f} "
              f"{int(ctx.counters[Counter.HBM_STALL_NS]) / 1e6:>12.3f} "
              f"{job.params.tslice_us:>9}", flush=True)
        check(job.error is None and job.steps_retired() == job.max_steps,
              f"({what}) {n}: {job.steps_retired()} of {job.max_steps} "
              f"steps retired, no fault ({job.error})")
        check(len(qrecs) == desched[n] == ctx.sched_count,
              f"({what}) {n}: {len(qrecs)} quantum records == "
              f"{desched[n]} SCHED_DESCHED on the ring == "
              f"{ctx.sched_count} dispatches")
        # Every grow, shrink and reset the policy counts happens in a
        # feedback decision, one at most of each per decision, so the
        # recorded stream steps each count by 0 or 1 and ends on the
        # policy's own; a decision that changed one and left no record
        # shows as a step of 2 or a short end.
        counts = ("grows", "shrinks", "resets")
        mine_st = next(d for d in policy.dump() if d["job"] == n)
        seen = dict.fromkeys(counts, 0)
        steps_ok = True
        for r in trecs:
            steps_ok &= all(r[k] - seen[k] in (0, 1) for k in counts)
            seen = {k: r[k] for k in counts}
        metric_ticks = policy.state_of(job).ticks
        check(steps_ok and seen == {k: mine_st[k] for k in counts}
              and n_ticks <= metric_ticks,
              f"({what}) {n}: {n_ticks} tick records of {metric_ticks} "
              f"metric ticks account for the policy's {seen} one "
              f"decision at a time")
        check(sums.tolist()
              == part.ledger.snapshot(ctx.ledger_slot).tolist()
              == ctx.counters.tolist(),
              f"({what}) {n}: the recorded deltas sum to the ledger words "
              f"bit for bit")
    if eng is not None:
        st = eng.stats()
        check(st["completed"] == jobs["engine"].state["completed"]
              and not eng.has_work(),
              f"({what}) engine: {st['completed']} requests served")
    return dict(jobs=jobs, eng=eng, ticks=ticks, wall=wall,
                own=inner.own_totals,
                start=start, recs=recs, window=window.window(), policy=policy,
                src=src.describe())


def contended_shares(recs) -> dict:
    """Per job, its share of the device time dispatched before the first
    job finished (every tenant runnable), and its finish time (ms from
    the first quantum), from a run's quantum records."""
    q = [r for r in recs if r["kind"] == "quantum"]
    t0 = min(r["t"] for r in q)
    last: dict = {}
    for r in q:
        last[r["job"]] = max(last.get(r["job"], 0), r["end"])
    t_end = min(last.values())
    dev = {n: sum(r["c"].get("device_time_ns", 0) for r in q
                  if r["job"] == n and r["end"] <= t_end) for n in last}
    total = max(1, sum(dev.values()))
    return {n: (dev[n] / total, (last[n] - t0) / 1e6) for n in sorted(last)}


def replay_runs(live) -> dict:
    """Phase 3r (b): the recorded run replayed offline under credit (its
    own scheduler: every counter total reproduces, RUNQ_WAIT_NS aside, as
    ``tests/test_sim_trace.py`` holds it), then under credit2 and SEDF
    (every recorded step retires, no ReplayError)."""
    from pbs_tpu_torch.sim import TraceRecorder, recorded_steps, \
        replay_partition
    from pbs_tpu_torch.telemetry import Counter

    steps = recorded_steps(live["recs"])
    out = {}
    for sched in ("credit", "credit2", "sedf"):
        part = replay_partition(live["recs"], scheduler=sched)
        rec = TraceRecorder()
        part.recorder = rec
        t0 = time.monotonic()
        quanta = part.run()
        host_ms = (time.monotonic() - t0) * 1e3
        check(all(part.job(n).steps_retired() == s for n, s in steps.items()),
              f"(b) {sched}: every recorded step retired ({steps}) in "
              f"{quanta} quanta, {part.clock.now_ns() / 1e6:.3f} virtual ms "
              f"({host_ms:.1f} host ms)")
        if sched == "credit":
            for n, job in live["jobs"].items():
                got = part.job(n).contexts[0].counters
                want = job.contexts[0].counters
                check(all(int(got[c]) == int(want[c]) for c in Counter
                          if c is not Counter.RUNQ_WAIT_NS),
                      f"(b) credit: {n}'s replayed counters equal its "
                      f"recorded totals")
        out[sched] = contended_shares(rec.records())
        print(f"  (b) {sched}: device share before the first finish, and "
              f"finish ms: " + ", ".join(
                  f"{n} {s:.3f} at {t:.1f}" for n, (s, t)
                  in out[sched].items()), flush=True)
    return out


def fidelity_axes(live) -> dict:
    """Phase 3r (b), last: the sim-vs-real fidelity report on (a)'s
    counter window; an axis the tier could not measure is absent."""
    from pbs_tpu_torch.hwtelem import fidelity_report

    w = live["window"]
    rep = fidelity_report(w, seed=0)
    check(rep["window"]["samples"] == len(w.samples)
          and rep["window"]["tier"] == w.tier
          and rep["axes"]["miss_rate"]["absent"]
          == (w.totals().get("cache-references", 0) <= 0),
          f"(b) fidelity over {len(w.samples)} samples of the {w.tier} "
          f"tier; miss_rate absent: {rep['axes']['miss_rate']['absent']}")
    for name, ax in rep["axes"].items():
        pred = ax.get("predicted_x1e6", ax.get("predicted"))
        meas = ax.get("measured_x1e6", ax.get("measured"))
        print(f"  (b) fidelity {name}: predicted {pred}, measured {meas}, "
              f"rel err {ax['rel_err_x1e6'] / 1e6:.4f}"
              + (" (absent)" if ax.get("absent") else ""))
    print(f"  (b) fidelity {rep['fidelity_x1e6'] / 1e6:.4f}, floor "
          f"{rep['floor_x1e6'] / 1e6:.2f}, margin "
          f"{rep['margin_x1e6'] / 1e6:+.4f}", flush=True)
    return rep


def recorded_workload(live, what: str):
    """The simulator workload of a recorded run: one steady tenant per
    job, its step time DEVICE_TIME_NS / STEPS_RETIRED and stall fraction
    HBM_STALL_NS / DEVICE_TIME_NS from the run's own (card) numbers, its
    starting SchedParams the run's. Returns the tenants (name, step ns,
    stall fraction) and the catalog builder."""
    from pbs_tpu_torch.runtime import SchedParams
    from pbs_tpu_torch.sim.workload import TenantSpec
    from pbs_tpu_torch.telemetry import Counter, SimProfile

    tenants = []
    for n, d in live["own"].items():
        dev = int(d[Counter.DEVICE_TIME_NS])
        steps = int(d[Counter.STEPS_RETIRED])
        stall = int(d[Counter.HBM_STALL_NS])
        tenants.append((n, dev // max(1, steps), stall / max(1, dev)))
        print(f"  {what} {n}: step {dev / max(1, steps) / 1e6:.3f} ms, "
              f"stall fraction {stall / max(1, dev):.4f} (CudaBackend's "
              f"own), start {live['start'][n]}")
    start = {n: dict(live["start"][n]) for n, _, _ in tenants}

    def build(seed, n_tenants, horizon_ns):
        return [TenantSpec(name=n, params=SchedParams(**start[n]),
                           profile=SimProfile.steady(
                               step_time_ns=step_ns, stall_frac=frac,
                               collective_wait_ns=0, jitter=RECORD_JITTER))
                for n, step_ns, frac in tenants]

    return tenants, build


def tune_on_recorded(live, tmp) -> dict:
    """Phase 3r (c): a simulator workload whose tenants are steady
    profiles built from (a)'s own (card) numbers — step time
    DEVICE_TIME_NS / STEPS_RETIRED and stall fraction HBM_STALL_NS /
    DEVICE_TIME_NS, each tenant's starting SchedParams — tuned by
    successive halving over the quick space; the winner written as a
    profile into ``tmp`` and replayed by ``check_profile``; the winner,
    the reference constants and the copied "serving" profile scored on
    the same workload."""
    from pbs_tpu_torch.sched import tune
    from pbs_tpu_torch.sim.workload import (register_workload,
                                            unregister_workload)

    tenants, build = recorded_workload(live, "(c)")
    register_workload(RECORD_WORKLOAD, build)
    try:
        t0 = time.monotonic()
        frontier = tune.successive_halving(
            RECORD_WORKLOAD, "feedback",
            configs=tune.QUICK_SPACE["feedback"], rungs=tune.QUICK_RUNGS)
        search_s = time.monotonic() - t0
        path = tune.write_profile(RECORD_WORKLOAD, frontier, tuned_dir=tmp)
        verdict = tune.check_profile(RECORD_WORKLOAD, tmp)
        check(verdict["ok"],
              f"(c) the written profile replays its check digest "
              f"{verdict['got_digest'][:16]} (score "
              f"{verdict['got_score_x1e6'] / 1e6:+.6f})")
        names = ("winner", "reference", "serving profile")
        params = [frontier["winner"]["params"],
                  tune.QUICK_SPACE["feedback"][0],
                  tune.load_profile("serving")["params"]]
        scores = tune.evaluate_params(RECORD_WORKLOAD, "feedback", params)
    finally:
        unregister_workload(RECORD_WORKLOAD)
    print(f"  (c) successive halving over {len(tune.QUICK_SPACE['feedback'])}"
          f" configs in {search_s:.2f} s: rungs "
          f"{json.dumps(frontier['rungs'])}")
    for name, p, s in zip(names, params, scores):
        print(f"  (c) {name}: score {s:+.6f} {json.dumps(p, sort_keys=True)}")
    print(f"  (c) profile {os.path.basename(path)}: "
          f"{json.dumps(tune.load_profile(RECORD_WORKLOAD, tmp)['check'])}",
          flush=True)
    return dict(frontier=frontier, scores=dict(zip(names, scores)),
                params=dict(zip(names, params)), tenants=tenants)


def record_summary(what, live, card) -> dict:
    """A live run's device share over weight share, from CudaBackend's own
    device time and from the overlaid one, and, with an engine, its TTFT,
    latency and decode tick."""
    from pbs_tpu_torch.telemetry import Counter

    weights = {n: s["weight"] for n, s in live["start"].items()}
    total_w = sum(weights.values())
    out = {}
    for label, dev in (
            ("card", {n: int(live["own"][n][Counter.DEVICE_TIME_NS])
                      for n in weights}),
            ("hw", {n: int(j.contexts[0].counters[Counter.DEVICE_TIME_NS])
                    for n, j in live["jobs"].items()})):
        total = max(1, sum(dev.values()))
        out[label] = {n: (dev[n] / total) / (weights[n] / total_w)
                      for n in weights}
        print(f"  ({what}) device share ({label}) / weight share: "
              + ", ".join(f"{n} {dev[n] / total:.3f} / "
                          f"{weights[n] / total_w:.3f} = {out[label][n]:.3f}"
                          for n in weights) + f" [{card}]")
    if live["eng"] is not None:
        st = live["eng"].stats()
        out["engine"] = st
        out["tick_ms"] = decode_tick_ms(live["ticks"])
        print(f"  ({what}) engine: TTFT p50 {st['ttft_p50_s'] * 1e3:.2f} / "
              f"p99 {st['ttft_p99_s'] * 1e3:.2f} ms, latency p50 "
              f"{st['latency_p50_s'] * 1e3:.2f} / p99 "
              f"{st['latency_p99_s'] * 1e3:.2f} ms (host clock); decode "
              f"tick {out['tick_ms']:.2f} ms (median) in "
              f"{live['wall']:.2f} s [{card}]", flush=True)
    return out


def record_replay_tune(make_tenants, device, make_tier, tmp, card,
                       counted=None) -> dict:
    """Phase 3r, (a)-(d), on whatever the callers hand it: the card's
    tenants over ``CudaBackend`` and the host's counter ladder here, toy
    tenants on the host and a scripted tier in the CPU twin
    (``tests/test_torch_record.py``). ``counted(what)``, a context
    manager, is entered just before each live run's first round and left
    just after its last (the card counts kernel launches in it)."""
    import contextlib

    from pbs_tpu_torch.hwtelem import probe_report
    from pbs_tpu_torch.knobs.profile import roundtrip_params
    from pbs_tpu_torch.sched import FeedbackPolicy, tune

    counted = counted or (lambda what: contextlib.nullcontext())
    tier = make_tier()
    rep = probe_report(None if tier is None else [tier])
    print(f"  hwtelem ladder: active {rep['active']}")
    for t in rep["tiers"]:
        print(f"    {t['tier']}: "
              + (f"events {t['events']}" if t["available"]
                 else f"unavailable ({t['reason']})"))
        for ev, why in t["degraded"].items():
            print(f"      {ev} absent: {why}")

    # (a) record, live
    live = record_run(
        "a", make_tenants, device, make_tier,
        os.path.join(tmp, "record-a.jsonl"),
        lambda part, src: FeedbackPolicy.from_source(part, src), counted)
    print(f"  (a) source {json.dumps(live['src'])}; feedback "
          f"{json.dumps(live['policy'].dump())}")
    check(live["policy"].hw_source is not None,
          "(a) the policy was armed by FeedbackPolicy.from_source")
    a = record_summary("a", live, card)

    # (b) replay, offline
    shares_by = replay_runs(live)
    fid = fidelity_axes(live)

    # (c) tune on the card's own numbers
    tuned = tune_on_recorded(live, tmp)

    # (d) arm the winner: its written profile through the knob round
    # trip (the load path of ``tune.policy_from_profile``), on (a)'s
    # constructor, so that the two runs differ in the tuned params alone
    prof = tune.load_profile(RECORD_WORKLOAD, tmp)
    winner = roundtrip_params(prof["policy"], dict(prof["params"]))
    armed = record_run(
        "d", make_tenants, device, make_tier,
        os.path.join(tmp, "record-d.jsonl"),
        lambda part, src: FeedbackPolicy.from_source(part, src, **winner),
        counted)
    win = tuned["frontier"]["winner"]["params"]
    pol, pol_a = armed["policy"], live["policy"]
    got = {p: getattr(pol, "window_len" if p == "window" else p)
           for p in win}
    check(got == win and pol.stale_after == pol_a.stale_after
          and pol.hw_source is not None
          and pol.fallback_us == pol_a.fallback_us,
          f"(d) the winner armed through its profile on (a)'s "
          f"constructor: {json.dumps(got, sort_keys=True)}, stale after "
          f"{pol.stale_after} ticks as in (a), fallback "
          f"{pol.fallback_us} us")
    print(f"  (d) feedback {json.dumps(pol.dump())}")
    d = record_summary("d", armed, card)
    return dict(live=live, armed=armed, shares=shares_by, fidelity=fid,
                tuned=tuned, engine={"a": a, "d": d})


def run_record_path(torch, gen, cfg, params, card):
    """Phase 3r on the card: 3c's tenants (score, mm and a bf16 engine on
    3s's script, weights 256 / 512 / 256) recorded live under credit and
    FeedbackPolicy over ``HwCounterSource(inner=CudaBackend())``, replayed
    offline, tuned on and re-run with the winner armed. Returns the launch
    counts and routes summed over the two live runs."""
    import contextlib
    import shutil

    t_phase = time.monotonic()
    reqs, arrivals = engine_script()
    n_ticks = engine_ticks([n for _, n in reqs], arrivals, ENGINE_SLOTS)
    wrappers = bwd_counts()
    total = {k: 0 for k in KERNELS}
    total_routes = {k: {"wgmma": 0, "simt": 0} for k in KERNELS}

    @contextlib.contextmanager
    def counted(what):
        reset_counts(wrappers)
        yield
        launches, routes = control_launches(wrappers)
        print(f"  ({what}) kernel launches {launches}, by route {routes}")
        for k in KERNELS:
            total[k] += launches[k]
            for r, n in routes[k].items():
                total_routes[k][r] += n
            n = launches[k]
            if k in ("flash_fwd", "instrumented_matmul"):
                check(n > 0 and routes[k] == {"wgmma": n, "simt": 0},
                      f"({what}) {k}: {n} launches under HwCounterSource "
                      f"over a cuda CudaBackend, every one on the "
                      f"tensor-core route ({routes[k]})")
            else:
                check(n == 0, f"({what}) {k}: {n} launches == 0")

    tmp, _ = paging_dir("3r")
    try:
        out = record_replay_tune(
            lambda: control_tenants(torch, gen, cfg, params, reqs, arrivals,
                                    n_ticks),
            "cuda", lambda: None, tmp, card, counted=counted)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 3r wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return total, total_routes, out["live"]


# -- phase 3n ----------------------------------------------------------------

#: Phase 3n's doorbell block: one channel per port the bus bridge forwards
#: (every virq sits below it) and, last, the one the parent rings when its
#: run has ended.
NATIVE_DB_CHANNELS = 64
NATIVE_STOP = NATIVE_DB_CHANNELS - 1
#: The engine's served tokens per overflow virq in 3n(b): each crossing
#: raises Virq.TELEMETRY, which rings the doorbell the monitor waits on.
NATIVE_SAMPLE_PERIOD = 48
#: Latency histograms of 3n's engine (ledger slots).
NATIVE_HIST_SLOTS = 32
#: 3n(d), the reference perf bench's method: a warm round, then the best
#: ns per op over this many timed rounds of NATIVE_BENCH_OPS ops each,
#: cyclic GC collected before and paused inside each round.
NATIVE_BENCH_ROUNDS = 5
NATIVE_BENCH_OPS = 4_000
#: Samples one histogram flush lands in 3n(d)'s record_many.
NATIVE_HIST_BATCH = 4
#: 3n(e): the recorded workload's simulated horizon per tier.
NATIVE_SIM_HORIZON_NS = 20 * 10 ** 9
#: 3n(f): batches drawn through the loader against the numpy gather, and
#: gathers of one batch's windows per timed round.
NATIVE_GATHER_BATCHES = 6
NATIVE_GATHER_TIMED = 500

#: The monitor process of 3n(c): attaches the partition's file-backed
#: ledger read-only and the doorbell block, waits on the doorbell and
#: snapshots every slot on each wakeup; a snapshot tears if any counter
#: reads lower than in the one before (the counters only grow). Prints
#: one JSON line when attached and one when the parent's stop channel
#: rings; that ring (or, failing it, its own deadline) is how it ends.
NATIVE_MONITOR = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from pbs_tpu_torch.runtime.doorbell import Doorbell
from pbs_tpu_torch.telemetry.ledger import Ledger
led = Ledger.file_backed(sys.argv[2], readonly=True, native=True)
db = Doorbell.file_backed(sys.argv[3], attach=True)
chan, stop = int(sys.argv[4]), int(sys.argv[5])
slots = list(range(led.num_slots))
print(json.dumps({"ledger": led.tier, "doorbell": db._nat is not None}),
      flush=True)
seq = db.seq()
last = led.snapshot_many(slots).copy()
wakeups = snaps = torn = virqs = 0
deadline = time.monotonic() + 600
while time.monotonic() < deadline and not db.pending(stop):
    s = db.wait(seq, timeout_s=1.0)
    if s == seq:
        continue
    seq, wakeups = s, wakeups + 1
    virqs += db.take(chan)
    snap = led.snapshot_many(slots)
    snaps += 1
    torn += int((snap < last).any())
    last = snap.copy()
virqs += db.take(chan)
final = led.snapshot_many(slots)
torn += int((final < last).any())
print(json.dumps({"wakeups": wakeups, "snapshots": snaps + 1, "torn": torn,
                  "virqs": virqs, "stopped": bool(db.take(stop)),
                  "sums": final.tolist()}), flush=True)
"""


def native_build() -> dict:
    """The port's native runtime and its fastcall module, built from
    ``pbs_tpu_torch/runtime/csrc`` with the host's g++ (phase 1 runs this
    beside nvcc): kind -> (seconds, path or None, error or None); 0.0
    seconds when the digest-named artifact was already built."""
    from pbs_tpu_torch.runtime import native

    out = {}
    for kind in ("runtime", "fastcall"):
        existed = native.artifact_path(kind).exists()
        t0 = time.monotonic()
        try:
            path, err = native.build_library(kind), None
        except native.BuildError as e:
            path, err = None, str(e)
        out[kind] = (0.0 if existed else time.monotonic() - t0, path, err)
    return out


def native_tiers(part) -> dict:
    """The tier of a partition's ledger and of each of its trace rings."""
    return {"ledger": part.ledger.tier,
            "rings": [t.tier for t in part.traces]}


def check_native(part) -> None:
    """A partition's ledger and every ring run on a native tier (the
    default pick wherever the runtime builds)."""
    tiers = native_tiers(part)
    check("python" not in [tiers["ledger"], *tiers["rings"]],
          f"partition {part.name!r}: ledger on the {tiers['ledger']} tier, "
          f"rings on {sorted(set(tiers['rings']))}")


class _Calls:
    """Counts the calls of methods installed over an instance's own."""

    def __init__(self):
        self.n: dict[str, int] = {}

    def wrap(self, obj, name: str, key: str) -> None:
        fn = getattr(obj, name)
        self.n.setdefault(key, 0)

        def counted(*a, **kw):
            self.n[key] += 1
            return fn(*a, **kw)

        setattr(obj, name, counted)


def engine_hists(job, eng, hist, batch) -> None:
    """Feed the engine's latency histograms from its Job: each tick's host
    ns, and each completion's TTFT and latency, staged in ``batch`` and
    flushed at tick end (the gateway pump's pattern)."""
    inner = job.step_fn

    def step(state):
        t0 = time.monotonic_ns()
        n0 = eng.requests_completed
        out = inner(state)
        batch.record("engine", "interactive", "tick",
                     time.monotonic_ns() - t0)
        new = eng.requests_completed - n0
        if new:
            for ttft, lat in zip(list(eng._ttfts)[-new:],
                                 list(eng._latencies)[-new:]):
                batch.record("engine", "interactive", "ttft",
                             int(ttft * 1e9))
                batch.record("engine", "interactive", "e2e",
                             int(lat * 1e9))
        batch.flush()
        return out

    job.step_fn = step


def native_runtime_run(make_tenants, device, tmp, card,
                       counted=None) -> dict:
    """Phase 3n (b) and (c) on whatever the caller hands it (3c's tenants
    over ``CudaBackend`` on the card, toy tenants in the CPU twin,
    ``tests/test_torch_native_path.py``): the tenants under credit and
    FeedbackPolicy in a Partition with ``ledger_path=`` and file-backed
    rings, the engine's latency histograms fed each tick, an overflow
    sample on the engine's TOKENS rearmed at each virq, and the bus
    bridged into a file-backed ``Doorbell`` that a monitor process waits
    on, snapshotting the ledger file at each wakeup. Checks every tier is
    native, every step retired and request served, the ledger words are
    the counters, no snapshot tore, the monitor's final sums are the
    ledger's and the doorbell counted every virq the bus raised and
    delivered. ``counted(what)`` is entered just before ``part.run`` and
    left just after (the card counts kernel launches in it)."""
    import contextlib

    from pbs_tpu_torch.obs.spans import HistBatch, LatencyHistograms
    from pbs_tpu_torch.runtime import (Doorbell, Partition, Virq,
                                       bridge_events)
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    counted = counted or (lambda what: contextlib.nullcontext())
    jobs, eng, ticks = make_tenants()
    part = Partition("native", source=CudaBackend(device=device),
                     scheduler="credit",
                     ledger_path=os.path.join(tmp, "ledger"),
                     trace_dir=os.path.join(tmp, "traces"))
    fb = FeedbackPolicy(part)
    for job in jobs.values():
        part.add_job(job)
    check_native(part)
    hist = LatencyHistograms(num_slots=NATIVE_HIST_SLOTS, native=True,
                             path=os.path.join(tmp, "engine.hist"))
    hb = HistBatch(hist, capacity=64)
    check(hist.ledger.tier != "python",
          f"(b) engine histograms on the {hist.ledger.tier} tier")
    engine_hists(jobs["engine"], eng, hist, hb)

    tele = int(Virq.TELEMETRY)
    sampler = part.sampler
    sampler.arm(jobs["engine"].contexts[0], Counter.TOKENS,
                period=NATIVE_SAMPLE_PERIOD)
    delivered = []

    def on_virq(port):
        delivered.append(port)
        for ev in sampler.drain():
            sampler.rearm(ev.sample_id)

    part.events.bind_virq(Virq.TELEMETRY, on_virq)
    raised = []
    part.events.add_tap(raised.append)
    db_path = os.path.join(tmp, "doorbell")
    db = Doorbell.file_backed(db_path, n_channels=NATIVE_DB_CHANNELS)
    check(db._nat is not None, "(c) the doorbell's sender is native")
    bridge_events(part.events, db)

    calls = _Calls()
    for name in ("resume", "suspend", "add", "add_many"):
        calls.wrap(part.ledger, name, f"ledger.{name}")
    for ring in part.traces:
        calls.wrap(ring, "emit", "ring.emit")
    flushes0 = sampler._trace_batch.flushes

    root = os.path.dirname(os.path.abspath(__file__))
    mon = subprocess.Popen(
        [sys.executable, "-c", NATIVE_MONITOR, root,
         os.path.join(tmp, "ledger"), db_path, str(tele), str(NATIVE_STOP)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        hello = json.loads(mon.stdout.readline() or "{}")
        check(hello.get("ledger") not in (None, "python")
              and hello.get("doorbell") is True,
              f"(c) the monitor process attached the ledger file on the "
              f"{hello.get('ledger')} tier and the doorbell block "
              f"(native: {hello.get('doorbell')})")
        with counted("b"):
            t0 = time.monotonic()
            quanta = part.run()
            wall = time.monotonic() - t0
    finally:
        db.send(NATIVE_STOP)  # the monitor's exit, whatever happened
        out, err = mon.communicate(timeout=120)
    report = json.loads(out.strip().splitlines()[-1]) if out.strip() else {}
    check(mon.returncode == 0 and report.get("stopped") is True,
          f"(c) the monitor exited {mon.returncode} on the stop channel "
          f"({err.strip()[-400:]})")

    slots = sorted(j.contexts[0].ledger_slot for j in jobs.values())
    sums = part.ledger.snapshot_many(range(part.ledger.num_slots))
    dev_ns = int(sums[:, Counter.DEVICE_TIME_NS].sum())
    host_ms_per_q = (wall * 1e9 - dev_ns) / max(1, quanta) / 1e6
    print(f"  (b) tiers {json.dumps(native_tiers(part))}, histograms "
          f"{hist.ledger.tier}, doorbell native; {quanta} quanta in "
          f"{wall:.3f} s wall, ledger device time {dev_ns / 1e9:.3f} s: "
          f"host time per quantum {host_ms_per_q:.3f} ms [{card}]",
          flush=True)
    print_tenants(jobs, Counter)
    print(f"  (b) feedback {json.dumps(fb.dump())}")
    for name, job in jobs.items():
        ctx = job.contexts[0]
        check(job.error is None and job.steps_retired() == job.max_steps,
              f"(b) {name}: {job.steps_retired()} of {job.max_steps} steps "
              f"retired, no fault ({job.error})")
        check(part.ledger.snapshot(ctx.ledger_slot).tolist()
              == ctx.counters.tolist(),
              f"(b) {name}: ledger snapshot equals the context counters")
    st = eng.stats()
    check(st["completed"] == jobs["engine"].state["completed"]
          and not eng.has_work(),
          f"(b) engine: {st['completed']} requests served")
    hb.flush()
    n_ttft = int(hist.counts("engine", "interactive", "ttft").sum())
    check(n_ttft == st["completed"]
          and int(hist.counts("engine", "interactive", "tick").sum())
          == jobs["engine"].steps_retired(),
          f"(b) engine histograms: {n_ttft} TTFT samples, one per "
          f"completion, and one tick sample per step; TTFT p50 "
          f"{hist.quantile('engine', 'interactive', 'ttft', 0.5) / 1e6:.2f}"
          f" / p99 {hist.quantile('engine', 'interactive', 'ttft', 0.99) / 1e6:.2f}"
          f" ms (bucket upper edges, host clock)")

    sent = sum(1 for p in raised if p == tele)
    print(f"  (c) monitor: {report['wakeups']} wakeups, "
          f"{report['snapshots']} snapshots, {report['torn']} torn; "
          f"doorbell counted {report['virqs']} TELEMETRY rings, the bus "
          f"raised {sent} and delivered {len(delivered)}", flush=True)
    check(report["torn"] == 0 and report["snapshots"] >= 2,
          f"(c) no snapshot of {report['snapshots']} tore")
    check(report["sums"] == sums.tolist(),
          f"(c) the monitor's final sums over {len(sums)} slots equal the "
          f"partition's ledger ({slots} in use)")
    check(sent > 0 and report["virqs"] == sent == len(delivered),
          f"(c) the doorbell's pending counts ({report['virqs']}) equal the "
          f"virqs the bus raised ({sent}) and delivered ({len(delivered)})")

    per_q = {k: v / max(1, quanta) for k, v in calls.n.items()}
    per_q["emit_batch.flush"] = (sampler._trace_batch.flushes
                                 - flushes0) / max(1, quanta)
    per_q["hist.record_many"] = hb.flushes / max(1, quanta)
    per_q["ledger.snapshot_many"] = 0.0
    print(f"  (b) runtime calls per quantum: "
          f"{json.dumps({k: round(v, 3) for k, v in sorted(per_q.items())})}")
    return dict(jobs=jobs, eng=eng, quanta=quanta, wall=wall, dev_ns=dev_ns,
                host_ms_per_q=host_ms_per_q, per_q=per_q, monitor=report,
                n_slots=part.ledger.num_slots, slots=slots,
                tiers=native_tiers(part))


def bench_ns(fn, reset, ops: int, rounds: int) -> float:
    """Best ns per op of ``rounds`` timed rounds after a warm one; cyclic
    GC collected before each round and paused inside it."""
    import gc

    reset()
    fn()
    best = float("inf")
    for _ in range(rounds):
        reset()
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter_ns()
            fn()
            dt = time.perf_counter_ns() - t0
        finally:
            gc.enable()
        best = min(best, dt / ops)
    return best


def tier_costs(slots: list, per_q: dict, ops: int = NATIVE_BENCH_OPS,
               rounds: int = NATIVE_BENCH_ROUNDS) -> dict:
    """Phase 3n(d): ns per op of the runtime calls (b) makes, on the
    Python, ctypes and fastcall tiers, on this host's CPU (``snapshot_many``
    over ``slots``, the partition's slots in use); and each tier's cost
    of one quantum's calls at (b)'s per-quantum counts."""
    import numpy as np

    from pbs_tpu_torch.obs.spans import LatencyHistograms
    from pbs_tpu_torch.obs.trace import EmitBatch, Ev, TraceBuffer
    from pbs_tpu_torch.runtime import native
    from pbs_tpu_torch.telemetry import Ledger
    from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS

    tiers = {"python": False, "ctypes": "ctypes"}
    if native.tier() == "fastcall":
        tiers["fastcall"] = True
    deltas = np.arange(1, NUM_COUNTERS + 1, dtype=np.uint64)
    slot_list = [int(x) for x in slots]
    n_slots = max(slot_list) + 1
    pick = int(Ev.SCHED_PICK)
    out = {}
    for tier, req in tiers.items():
        led = Ledger(n_slots, native=req)
        ring = TraceBuffer(capacity=ops, native=req)
        batch = EmitBatch(TraceBuffer(capacity=ops, native=req), capacity=8)
        hist = LatencyHistograms(num_slots=8, native=req)
        h_slots = np.full(NATIVE_HIST_BATCH,
                          hist.slot_of("engine", "interactive", "tick"),
                          dtype=np.int64)
        h_vals = (np.arange(NATIVE_HIST_BATCH, dtype="<u8") + 1) << 20
        assert {led.tier, ring.tier, batch.ring.tier,
                hist.ledger.tier} == {tier}, tier

        def resume():
            r = led.resume
            for i in range(ops):
                r(1, i + 1)

        def suspend():
            s = led.suspend
            for _ in range(ops):
                s(1, deltas)

        def add_many():
            a = led.add_many
            for _ in range(ops):
                a(1, deltas)

        def snapshot_many():
            s = led.snapshot_many
            for _ in range(ops):
                s(slot_list)

        def emit():
            e = ring.emit
            for i in range(ops):
                e(i, pick, 1, 100_000)

        def flush():
            e, f = batch.emit, batch.flush
            for i in range(ops):
                e(i, pick, 1, 100_000)
                f()

        def record_many():
            r = hist.record_many
            for _ in range(ops):
                r(h_slots, h_vals)

        def drain():
            ring.consume(ops)
            batch.ring.consume(ops)

        costs = {
            "ledger.resume": bench_ns(resume, drain, ops, rounds),
            "ledger.suspend": bench_ns(suspend, drain, ops, rounds),
            "ledger.add_many": bench_ns(add_many, drain, ops, rounds),
            "ledger.snapshot_many": bench_ns(snapshot_many, drain, ops,
                                             rounds),
            "ring.emit": bench_ns(emit, drain, ops, rounds),
            "emit_batch.flush": bench_ns(flush, drain, ops, rounds),
            "hist.record_many": bench_ns(record_many, drain, ops, rounds),
        }
        costs["per_quantum_us"] = sum(
            costs[k] * per_q.get(k, 0.0) for k in costs) / 1e3
        out[tier] = costs
    return out


def print_tier_costs(costs: dict, per_q: dict, slots: list,
                     card: str) -> None:
    tiers = list(costs)
    print(f"  (d) ns per op on the host CPU ({NATIVE_BENCH_ROUNDS} rounds "
          f"of {NATIVE_BENCH_OPS}, best; snapshot_many over slots {slots}, "
          f"record_many of {NATIVE_HIST_BATCH} samples, a flush of "
          f"one staged record) [{card}]")
    print(f"  {'call':<22} {'per quantum':>11} "
          + " ".join(f"{t:>10}" for t in tiers))
    for k in costs[tiers[0]]:
        if k == "per_quantum_us":
            continue
        print(f"  {k:<22} {per_q.get(k, 0.0):>11.3f} "
              + " ".join(f"{costs[t][k]:>10.1f}" for t in tiers))
    print(f"  {'one quantum (us)':<22} {'':>11} "
          + " ".join(f"{costs[t]['per_quantum_us']:>10.3f}" for t in tiers),
          flush=True)


def native_sim(build, horizon_ns: int = NATIVE_SIM_HORIZON_NS) -> dict:
    """Phase 3n(e): the five tuned profiles' check digests replayed on the
    native sim core; a recorded workload (``build``, a catalog builder)
    run under credit on the Python and native tiers, reports and trace
    digests identical, with each tier's simulated seconds per wall
    second."""
    from pbs_tpu_torch.sched import tune
    from pbs_tpu_torch.sim import SimEngine
    from pbs_tpu_torch.sim.workload import (register_workload,
                                            unregister_workload)

    for wl in tune.tuned_workloads():
        v = tune.check_profile(wl, native=True)
        check(v["ok"] and v["verified_tier"] in ("fastcall", "ctypes"),
              f"(e) tuned profile {wl!r}: check digest "
              f"{v['got_digest'][:16]} replays on the {v['verified_tier']} "
              f"sim tier (recorded on {v['recorded_tier']})")
    register_workload(RECORD_WORKLOAD, build)
    try:
        runs = {}
        for tier in ("python", "native"):
            eng = SimEngine(workload=RECORD_WORKLOAD, policy="credit",
                            seed=0, horizon_ns=horizon_ns, record=True,
                            native=False if tier == "python" else True)
            t0 = time.monotonic()
            rep = eng.run()
            wall = time.monotonic() - t0
            runs[tier] = dict(report=rep, wall=wall,
                              used=eng.native_tier_used or "python")
            print(f"  (e) {RECORD_WORKLOAD} under credit on the "
                  f"{runs[tier]['used']} tier: {rep['quanta']} quanta, "
                  f"{horizon_ns / 1e9:.0f} simulated s in {wall:.3f} s "
                  f"wall, {horizon_ns / 1e9 / wall:.1f} simulated s per "
                  f"wall s; digest {rep['trace_digest'][:16]}", flush=True)
    finally:
        unregister_workload(RECORD_WORKLOAD)
    py, nat = runs["python"]["report"], runs["native"]["report"]
    check(runs["native"]["used"] in ("fastcall", "ctypes")
          and json.dumps(py, sort_keys=True) == json.dumps(nat,
                                                           sort_keys=True),
          f"(e) the recorded workload's report and trace digest are "
          f"identical on the Python and {runs['native']['used']} tiers")
    return runs


def native_gather(device, tmp, vocab: int, n_tokens: int, batch: int,
                  seq: int, seed: int, n_batches: int = NATIVE_GATHER_BATCHES,
                  card: str = "") -> dict:
    """Phase 3n(f): 3p's corpus and loader (``ShardedBatchSource`` under
    a ``Prefetcher``) reading through ``pbst_gather_rows``, each batch's
    bytes against the numpy gather of the same windows; and the host ms
    of one batch's gather on each path."""
    import numpy as np

    from pbs_tpu_torch.data import (Prefetcher, ShardedBatchSource,
                                    TokenDataset, write_token_file)

    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=n_tokens)
    path = os.path.join(tmp, "corpus.tok")
    write_token_file(path, tokens)
    ds = TokenDataset(path)
    check(ds._nat is not None, "(f) the token dataset gathers through "
          "pbst_gather_rows")
    want = ShardedBatchSource(ds, batch, seq, seed=seed)
    src = ShardedBatchSource(ds, batch, seq, seed=seed)
    same = []
    with Prefetcher(src, depth=2, device=device) as pf:
        for _ in range(n_batches):
            got = next(pf).cpu().numpy()
            starts = want._starts(want.step)
            want.step += 1
            ref = np.stack([tokens[s:s + seq] for s in starts]).astype(
                got.dtype)
            same.append(got.tobytes() == ref.tobytes())
    starts = want._starts(0)
    n = NATIVE_GATHER_TIMED

    def gather_native():
        for _ in range(n):
            ds._gather(starts, seq)

    def gather_numpy():
        for _ in range(n):
            np.stack([ds._mm[s:s + seq] for s in starts])

    t_nat = bench_ns(gather_native, lambda: None, n, NATIVE_BENCH_ROUNDS)
    t_np = bench_ns(gather_numpy, lambda: None, n, NATIVE_BENCH_ROUNDS)
    check(all(same), f"(f) {len(same)} loader batches of ({batch}, {seq}) "
          f"through pbst_gather_rows byte-equal to the numpy gather; one "
          f"batch's gather {t_nat / 1e6:.3f} ms native, {t_np / 1e6:.3f} ms "
          f"numpy (host CPU) [{card}]")
    return dict(batches=len(same), native_ms=t_nat / 1e6,
                numpy_ms=t_np / 1e6)


def run_native_path(torch, gen, cfg, params, card, built, recorded):
    """Phase 3n on the card: (a) the native runtime phase 1 built; (b)
    3c's tenants (score, mm and the bf16 engine on 3s's script, weights
    256 / 512 / 256) under credit in a Partition on the C ledger, rings
    and histograms, with (c) a monitor process across the ledger file and
    a doorbell; (d) tier costs of (b)'s calls on the card host's CPU;
    (e) the native sim core on the tuned profiles and 3r's recorded
    workload (``recorded``, 3r(a)'s live run); (f) 3p's loader through
    the native gather. Returns the launch counts and routes of (b) and
    (d)'s ns per call by tier."""
    import contextlib
    import shutil

    from pbs_tpu_torch.runtime import native

    t_phase = time.monotonic()
    for kind, (secs, path, err) in built.items():
        print(f"  (a) {kind}: {secs:.2f} s -> "
              f"{path.name if path is not None else err}")
    tier = native.tier()
    print(f"  (a) tier {tier}"
          + ("" if tier == "fastcall"
             else f" (fastcall unavailable: {native.last_failure()})"),
          flush=True)
    check(tier in ("fastcall", "ctypes"),
          f"(a) the native runtime loads on the {tier} tier")

    reqs, arrivals = engine_script()
    n_ticks = engine_ticks([n for _, n in reqs], arrivals, ENGINE_SLOTS)
    wrappers = bwd_counts()
    result = {}

    @contextlib.contextmanager
    def counted(what):
        reset_counts(wrappers)
        yield
        launches, routes = control_launches(wrappers)
        result.update(launches=launches, routes=routes)
        print(f"  ({what}) kernel launches {launches}, by route {routes}")
        for k in KERNELS:
            n = launches[k]
            if k in ("flash_fwd", "instrumented_matmul"):
                check(n > 0 and routes[k] == {"wgmma": n, "simt": 0},
                      f"({what}) {k}: {n} launches, every one on the "
                      f"tensor-core route ({routes[k]})")
            else:
                check(n == 0, f"({what}) {k}: {n} launches == 0")

    tmp, _ = paging_dir("3n")
    try:
        run = native_runtime_run(
            lambda: control_tenants(torch, gen, cfg, params, reqs, arrivals,
                                    n_ticks),
            "cuda", tmp, card, counted=counted)
        costs = tier_costs(run["slots"], run["per_q"])
        print_tier_costs(costs, run["per_q"], run["slots"], card)
        print(f"  (d) host time per quantum {run['host_ms_per_q']:.3f} ms; "
              f"the runtime calls of one quantum take "
              + ", ".join(f"{costs[t]['per_quantum_us']:.3f} us on {t}"
                          for t in costs) + f" [{card}]", flush=True)
        native_sim(recorded_workload(recorded, "(e)")[1])
        native_gather("cuda", tmp, cfg.vocab, PAGING_CORPUS_TOKENS,
                      TRAIN_BATCH, TRAIN_SEQ, PAGING_SEED, card=card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 3n wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return result["launches"], result["routes"], costs


# -- phase 3j ----------------------------------------------------------------


def journal_script():
    """Phase 3j's script: 3s's 24 requests (prompts of 16-128 tokens,
    budgets of 8-64), 8 at tick 0 and then one a tick (3s sends two a
    tick), so that arrivals go on past (a)'s crash."""
    reqs, _ = engine_script()
    arrivals = {0: list(range(ENGINE_FIRST))}
    for i in range(ENGINE_FIRST, len(reqs)):
        arrivals[1 + i - ENGINE_FIRST] = [i]
    return reqs, arrivals


def journal_payload(reqs, i) -> dict:
    prompt, n = reqs[i]
    return {"prompt": prompt, "max_new": n}


def journal_tenant(n: int) -> str:
    return "chat" if n <= GW_CHAT_MAX_NEW else "bulk"


def journal_backend(make_engine, name, tokens, backend_cls=None):
    """A fresh engine behind a ``BatcherBackend`` (or ``backend_cls``).
    Each completion's tokens land in ``tokens`` under its gateway rid,
    read through the backend's own map from engine id to request; every
    rid the gateway dispatches to it is listed in ``be.dispatched``.
    Returns (engine, backend)."""
    from pbs_tpu_torch.gateway import BatcherBackend

    eng = make_engine()
    be = (backend_cls or BatcherBackend)(name, eng)
    be.dispatched = []
    engine_step, dispatch = eng.step, be.dispatch_request

    def step():
        out = engine_step()
        for c in out:
            req = be._by_engine_rid.get(c.request_id)
            if req is not None:
                tokens[req.rid] = list(c.tokens)
        return out

    def dispatch_request(req, now_ns):
        be.dispatched.append(req.rid)
        dispatch(req, now_ns)

    eng.step, be.dispatch_request = step, dispatch_request
    return eng, be


def timed_commits(journal, samples: list) -> None:
    """Time every group commit of ``journal`` that wrote a frame (host
    ns, into ``samples``; a tick with nothing staged writes nothing):
    the gateway calls ``commit`` through the attribute."""
    commit = journal.commit

    def timed():
        t = time.perf_counter_ns()
        n = commit()
        if n:
            samples.append(time.perf_counter_ns() - t)
        return n

    journal.commit = timed


def journal_tick(gw, reqs, arrivals, client, tick) -> list:
    """One tick of the client and the gateway: submit this tick's
    arrivals (a request costs its budget), then pump once. Returns the
    tick's completions."""
    for i in arrivals.get(tick, []):
        n = reqs[i][1]
        r = gw.submit(journal_tenant(n), journal_payload(reqs, i), cost=n)
        if not r.admitted:
            check(False, f"request {i} admitted ({r.reason})")
        client["subs"][r.rid] = i
    done = gw.tick()
    client["done"].extend(done)
    return done


def latency_view(done, rids) -> dict:
    """Client-side TTFT (admission to the first token of the engine that
    served the request: latency minus that engine's service time plus
    its TTFT) and latency, in ms, nearest-rank p50/p99 over ``rids``."""
    from pbs_tpu_torch.utils.stats import nearest_rank

    info = dict(done)
    ttft = sorted((info[r]["latency_ns"] - info[r]["service_ns"]
                   + info[r]["ttft_ns"]) / 1e6 for r in rids)
    lat = sorted(info[r]["latency_ns"] / 1e6 for r in rids)
    return {"n": len(rids),
            "ttft_p50": nearest_rank(ttft, 0.5),
            "ttft_p99": nearest_rank(ttft, 0.99),
            "lat_p50": nearest_rank(lat, 0.5),
            "lat_p99": nearest_rank(lat, 0.99)}


def journal_fsyncs(journal) -> int:
    """fsyncs a journal's commits made: one every ``fsync_every``
    commits (0 = never; the commit path's rule)."""
    every = journal.fsync_every
    return journal.commits // every if every > 0 else 0


def first_difference(got: list, want: list) -> int:
    return next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))


def crash_and_recover(make_params, make_engine, reqs, arrivals, tmp,
                      kill_window, seed=JOURNAL_SEED, release=None,
                      counted=None) -> dict:
    """Phase 3j (a), on whatever the caller hands it: the flagship bf16
    engine on the card, a toy engine on the host in the CPU twin
    (``tests/test_torch_recovery.py``). The script through a journaled
    ``Gateway`` over a ``BatcherBackend`` (the journal at the registry's
    defaults) until a ``ProcessKill`` through the fault plan at the top
    of a tick drawn from ``kill_window`` by ``seed``; then everything in
    memory is dropped (gateway, backend, engine, its KV cache and the
    weights), the weights are rebuilt from their seed, a fresh engine
    built, the gateway recovered from the journal file alone with the
    client's prompts resent by rid (the journal holds no payloads), and
    the script runs on to its end. Then the same script through an
    uninterrupted journaled gateway, for the tokens. ``counted(what)``
    is entered around the crashed run (the card counts kernel launches
    in it); ``release`` frees device memory after the drop. Every check
    raises ``Failed``. Returns the books, tokens and times."""
    import contextlib
    import gc
    import shutil

    import numpy as np

    from pbs_tpu_torch.faults import injector as faults
    from pbs_tpu_torch.faults.plan import FaultPlan, FaultSpec
    from pbs_tpu_torch.gateway import (Gateway, GatewayJournal,
                                       ProcessKill, TenantQuota,
                                       read_journal, recover_gateway)
    from pbs_tpu_torch.gateway.journal import Jr, iter_interned
    from pbs_tpu_torch.gateway.recovery import (apply_recover_transform,
                                                replay, state_digest)
    from pbs_tpu_torch.utils.clock import MonotonicClock

    counted = counted or (lambda what: contextlib.nullcontext())
    quotas = {k: q for k, q in gateway_quotas(TenantQuota).items()
              if k != "probe"}
    last = max(arrivals)
    commit_ns: list = []

    def fresh(path, params, tokens):
        eng, be = journal_backend(lambda: make_engine(params), "engine",
                                  tokens)
        gw = Gateway([be], quotas=dict(quotas), clock=MonotonicClock(),
                     journal=GatewayJournal.create(path))
        return eng, be, gw

    kill_tick = int(np.random.default_rng(seed).integers(
        kill_window[0], kill_window[1] + 1))
    path = os.path.join(tmp, "gateway.jrnl")
    at_kill = os.path.join(tmp, "at-kill.jrnl")
    client = {"subs": {}, "done": []}
    tokens: dict = {}
    t0 = time.monotonic()
    params = make_params()
    params_s = time.monotonic() - t0
    eng, be, gw = fresh(path, params, tokens)
    timed_commits(gw._journal, commit_ns)
    faults.install(FaultPlan(seed=seed, specs=(FaultSpec(
        "gateway.process.kill", "kill", p=1.0, after=kill_tick,
        times=1),)))
    killed = None
    with counted("a"):
        tick = 0
        try:
            while tick <= last or gw.busy():
                if faults.consult("gateway.process.kill",
                                  "proc") is not None:
                    raise ProcessKill("process", tick)
                journal_tick(gw, reqs, arrivals, client, tick)
                tick += 1
        except ProcessKill as pk:
            killed = pk
        finally:
            faults.uninstall()
        check(killed is not None,
              f"(a) the planned kill at tick {kill_tick} fired")
        # The kill. First the evidence the checks need: a copy of the
        # file as the crash left it, the in-flight and queued sets, the
        # client's books. Then the process's memory goes.
        shutil.copy(path, at_kill)
        inflight_at_kill = sorted(gw.inflight)
        queued_at_kill = [r.rid for r in gw.queue.pending()]
        done_at_kill = [rid for rid, _ in client["done"]]
        admitted_at_kill = set(client["subs"])
        gen0 = (gw._journal.commits, journal_fsyncs(gw._journal))
        check(killed.position == kill_tick and done_at_kill
              and queued_at_kill and inflight_at_kill,
              f"(a) ProcessKill at the top of tick {killed.position} "
              f"(drawn {kill_tick} from {list(kill_window)} by seed "
              f"{seed}): {len(done_at_kill)} completed, "
              f"{len(queued_at_kill)} queued, {len(inflight_at_kill)} in "
              f"flight at the kill")
        # An independent replay of the copy, for the checks; timed on its
        # own, it is the read+replay part of recover_gateway's work.
        t0 = time.monotonic()
        view = read_journal(at_kill)
        st = replay(view.records, 0)
        apply_recover_transform(st)
        digest = state_digest(st)
        replay_s = time.monotonic() - t0
        t_crash = time.monotonic()
        gw._journal.abandon()
        del gw, be, eng, params
        gc.collect()
        if release is not None:
            release()
        t_dropped = time.monotonic()
        params = make_params()
        t_weights = time.monotonic()
        new_tokens: dict = {}
        eng, be = journal_backend(lambda: make_engine(params), "engine",
                                  new_tokens)
        t_engine = time.monotonic()
        payloads = {rid: journal_payload(reqs, i)
                    for rid, i in client["subs"].items()}
        gw, info = recover_gateway(path, [be], clock=MonotonicClock(),
                                   payloads=payloads)
        t_gateway = time.monotonic()
        timed_commits(gw._journal, commit_ns)
        first_token_s = None
        while tick <= last or gw.busy():
            journal_tick(gw, reqs, arrivals, client, tick)
            if first_token_s is None and eng.tokens_emitted:
                first_token_s = time.monotonic() - t_crash
            tick += 1
        gw._journal.close()
        gen1 = (gw._journal.commits, journal_fsyncs(gw._journal))
    tokens.update(new_tokens)

    # -- checks ------------------------------------------------------------
    check(info.state_digest == digest,
          f"(a) state_digest {info.state_digest[:16]} == an independent "
          f"replay of the file copied at the kill ({digest[:16]})")
    check(info.rids == admitted_at_kill,
          f"(a) the journal admitted exactly the {len(admitted_at_kill)} "
          f"rids the client was told were admitted before the kill")
    check(info.done == set(done_at_kill),
          f"(a) RecoveryInfo.done == the {len(done_at_kill)} completions "
          f"the client saw before the kill")
    want_requeued = sorted(inflight_at_kill,
                           key=lambda r: (st.reqs[r].submit_ns, r))
    check(info.requeued_inflight == want_requeued,
          f"(a) requeued_inflight == the {len(inflight_at_kill)} in flight "
          f"at the kill, oldest first")
    post = sorted(set(client["subs"]) - admitted_at_kill)
    check(post and all("-r1-" in rid for rid in post),
          f"(a) the {len(post)} rids admitted after recovery carry -r1- "
          f"({post[:2]})")
    redone = sorted(set(be.dispatched) & info.done)
    check(not redone, f"(a) no rid in RecoveryInfo.done dispatched again "
                      f"(of {len(be.dispatched)} dispatches: {redone[:3]})")
    done_rids = [rid for rid, _ in client["done"]]
    check(len(done_rids) == len(set(done_rids)) == len(reqs)
          and set(done_rids) == set(client["subs"]),
          f"(a) every admitted rid completed exactly once across both "
          f"generations ({len(done_rids)} completions, "
          f"{len(set(done_rids))} distinct, {len(reqs)} requests)")
    short = {rid: c["tokens"] for rid, c in client["done"]
             if c["tokens"] != reqs[client["subs"][rid]][1]}
    check(not short, f"(a) every completion has its budget's tokens "
                     f"({short})")
    final = read_journal(path)
    names = {sid: n for n, sid in iter_interned(final.records)}
    k = max(i for i, r in enumerate(final.records) if r[1] == Jr.RECOVER)
    again = sorted({names[r[3]] for r in final.records[k:]
                    if r[1] == Jr.DISPATCH} & info.done)
    check(final.generation == 1 and final.torn_bytes == 0 and not again,
          f"(a) the journal after recovery: generation {final.generation}"
          f" == 1, no torn tail, no DISPATCH of a done rid after the "
          f"RECOVER record ({again[:3]})")
    straddle = sorted(info.rids - info.done)

    # -- the uninterrupted run ---------------------------------------------
    ref_client = {"subs": {}, "done": []}
    ref_tokens: dict = {}
    ref_params = make_params()
    r_eng, r_be, r_gw = fresh(os.path.join(tmp, "uninterrupted.jrnl"),
                              ref_params, ref_tokens)
    tick = 0
    while tick <= last or r_gw.busy():
        journal_tick(r_gw, reqs, arrivals, ref_client, tick)
        tick += 1
    r_gw._journal.close()
    check(sorted(ref_client["subs"].values()) == list(range(len(reqs)))
          and len(ref_client["done"]) == len(reqs),
          f"(a) the uninterrupted run completed "
          f"{len(ref_client['done'])} of {len(reqs)}")
    got = {client["subs"][rid]: tokens[rid] for rid in client["subs"]}
    want = {ref_client["subs"][rid]: ref_tokens[rid]
            for rid in ref_client["subs"]}
    differ = {i: first_difference(got[i], want[i])
              for i in sorted(got) if got[i] != want[i]}
    ref_rid = {i: rid for rid, i in ref_client["subs"].items()}
    del r_eng, r_be, r_gw, ref_params
    return dict(
        kill_tick=kill_tick, info=info, digest=digest, tokens=got,
        ref_tokens=want, differ=differ, straddle=straddle,
        inflight_at_kill=inflight_at_kill, queued_at_kill=queued_at_kill,
        done_at_kill=done_at_kill, post=post, at_kill=at_kill, path=path,
        journal={"bytes": os.path.getsize(path),
                 "records": len(final.records), "frames": final.frames,
                 "commits": gen0[0] + gen1[0],
                 "fsyncs": gen0[1] + gen1[1],
                 "commit_ns": sorted(commit_ns)},
        times={"params_s": params_s, "drop_s": t_dropped - t_crash,
               "weights_s": t_weights - t_dropped,
               "engine_s": t_engine - t_weights,
               "recover_gateway_s": t_gateway - t_engine,
               "replay_s": replay_s, "first_token_s": first_token_s},
        latency={"crashed": latency_view(client["done"], straddle),
                 "uninterrupted": latency_view(
                     ref_client["done"],
                     [ref_rid[client["subs"][r]] for r in straddle])})


def crash_lines(out: dict, card: str) -> None:
    """Print (a)'s books, journal costs, time to recover and latencies."""
    from pbs_tpu_torch.utils.stats import nearest_rank

    info, jr, t = out["info"], out["journal"], out["times"]
    rest_ms = (t["recover_gateway_s"] - t["replay_s"]) * 1e3
    print(f"  (a) kill at the top of tick {out['kill_tick']}: "
          f"{len(out['done_at_kill'])} completed, "
          f"{len(out['queued_at_kill'])} queued, "
          f"{len(out['inflight_at_kill'])} in flight; recovered generation "
          f"{info.generation}: {len(info.recovered)} live rids, "
          f"{len(info.requeued_inflight)} requeued in flight, "
          f"{len(info.done)} done, torn {info.torn_bytes} B, digest "
          f"{info.state_digest[:16]}; {len(out['post'])} admitted after "
          f"recovery (-r1-); the client resent the prompts of the "
          f"{len(info.recovered)} live rids by rid (the journal holds "
          f"no payloads)", flush=True)
    ns = jr["commit_ns"]
    print(f"  (a) journal: {jr['bytes']} bytes, {jr['records']} records in "
          f"{jr['frames']} frames, {jr['commits']} commits, "
          f"{jr['fsyncs']} fsyncs (journal.fsync_every default); host us "
          f"per commit p50 {nearest_rank(ns, 0.5) / 1e3:.1f}, p99 "
          f"{nearest_rank(ns, 0.99) / 1e3:.1f} (n={len(ns)}) [{card}]",
          flush=True)
    print(f"  (a) time to recover (crash to the first token after "
          f"recovery) {t['first_token_s'] * 1e3:.1f} ms: drop "
          f"{t['drop_s'] * 1e3:.1f} ms, weights rebuilt from their seed "
          f"{t['weights_s'] * 1e3:.1f} ms (first build "
          f"{t['params_s'] * 1e3:.1f} ms), engine rebuild "
          f"{t['engine_s'] * 1e3:.1f} ms, recover_gateway "
          f"{t['recover_gateway_s'] * 1e3:.1f} ms (journal read+replay "
          f"{t['replay_s'] * 1e3:.1f} ms, timed just before on the same "
          f"bytes; the rest, {rest_ms:.1f} ms, the gateway's rebuild "
          f"and the reopen), then the first "
          f"tick's token; the journal's file system is the checkout's "
          f"[{card}]", flush=True)
    for what, v in out["latency"].items():
        print(f"  (a) {v['n']} requests straddling the crash, {what}: TTFT "
              f"p50/p99 {v['ttft_p50']:.1f} / {v['ttft_p99']:.1f} ms, "
              f"latency p50/p99 {v['lat_p50']:.1f} / {v['lat_p99']:.1f} ms "
              f"[{card}]", flush=True)
    print(f"  (a) tokens against the uninterrupted journaled run: "
          f"{len(out['differ'])} of {len(out['tokens'])} requests differ "
          f"(request: first differing position) {out['differ']}",
          flush=True)


def federation_member(make_engine, name, clock, tokens, switch_cost_ns,
                      gateway=None):
    """One federation member: a Gateway over one engine, the serving
    profile model armed (``profile_switch_cost_ns``). Its backend
    records the service scale the member's knob adoption sets (the
    engine itself does not slow down). ``gateway`` is the gateway
    package to build it from (default: the port's)."""
    if gateway is None:
        import pbs_tpu_torch.gateway as gateway
    BatcherBackend, Gateway = gateway.BatcherBackend, gateway.Gateway

    class ScaledBatcherBackend(BatcherBackend):
        service_scale = 1.0

        def set_service_scale(self, scale: float) -> None:
            self.service_scale = float(scale)

    _, be = journal_backend(make_engine, f"{name}e", tokens,
                            ScaledBatcherBackend)
    gw = Gateway([be], clock=clock, name=name,
                 max_queued=4 * GW_MAX_QUEUED)
    gw.profile_switch_cost_ns = switch_cost_ns
    return gw


def federation_run(make_engine, reqs, tmp, seed=JOURNAL_SEED,
                   release=None) -> dict:
    """Phase 3j (b): FED_MEMBERS ``FederatedGateway`` members in one
    process, each over its own engine (the engines share one copy of the
    weights), a shared journal, (a)'s script to FED_TENANTS tenants.
    Along the run: a canary-scoped knob push to one member (per-member
    watchers), the death of the busiest member, a seeded drain and a
    rejoin, and a crash of the whole process recovered by
    ``recover_federation`` from the journal. Every check raises
    ``Failed``; returns the books."""
    import gc
    import shutil

    import numpy as np

    from pbs_tpu_torch.gateway import (FederatedGateway, GatewayJournal,
                                       TenantQuota, read_journal)
    from pbs_tpu_torch.gateway.journal import Jr
    from pbs_tpu_torch.gateway.recovery import (apply_recover_transform,
                                                recover_federation,
                                                replay, state_digest)
    from pbs_tpu_torch.knobs.channel import KnobChannel
    from pbs_tpu_torch.utils.clock import SEC, VirtualClock

    rng = np.random.default_rng([seed, 3])
    tick_ns = FED_TICK_NS
    clock = VirtualClock()
    tokens: dict = {}
    member_ms: dict = {}

    def member(name):
        t = time.monotonic()
        gw = federation_member(make_engine, name, clock, tokens,
                               FED_SWITCH_COST_NS)
        member_ms[name] = (time.monotonic() - t) * 1e3
        return gw

    path = os.path.join(tmp, "federation.jrnl")
    journal = GatewayJournal.create(path)
    fed = FederatedGateway([member(f"gw{i}") for i in range(FED_MEMBERS)],
                           clock=clock, renew_period_ns=4 * tick_ns,
                           lease_ttl_ns=6 * tick_ns, journal=journal)
    quotas = {f"t{j}": TenantQuota(
        rate=GW_RATE, burst=GW_BURST, weight=256,
        slo="interactive" if j % 2 == 0 else "batch",
        max_queued=GW_MAX_QUEUED) for j in range(FED_TENANTS)}
    for t, q in quotas.items():
        fed.register_tenant(t, q)
    knob_path = os.path.join(tmp, "knobs.led")
    writer = KnobChannel.create(knob_path)
    fed.attach_knobs(KnobChannel.attach(knob_path), per_member=True)
    baseline = {n: [b.service_scale for b in m.backends]
                for n, m in sorted(fed.members.items())}
    _, arrivals = journal_script()
    last = max(arrivals)
    subs, done, cost_of = {}, [], {}
    start_ns = clock.now_ns()
    canary = sorted(fed.members)[int(rng.integers(0, FED_MEMBERS))]
    books: dict = {}
    tick = 0
    crashed = False
    while tick <= last or fed.busy():
        if tick == FED_PUSH_TICK:
            writer.push({"sched.feedback.tslice_min_us": 100,
                         "sched.feedback.tslice_max_us": FED_CANARY_MAX_US},
                        scope=[canary])
        if tick == FED_KILL_TICK:
            # The member holding the most work dies (ties: the first).
            victim = max(sorted(fed.members), key=lambda n: len(
                fed.members[n].inflight) + fed.members[n].queue.depth())
            vm = fed.members[victim]
            casualties = sorted(vm.inflight) + [
                r.rid for r in vm.queue.pending()]
            before = fed.handoffs
            # A member's death inside the federation, no process signal:
            # the method is bound first, since the repo's chip-client
            # check reads any ".kill(" call in a chip script as a signal.
            member_death = fed.kill
            member_death(victim)
            books["kill"] = dict(victim=victim, casualties=casualties,
                                 handoffs=fed.handoffs - before)
        if tick == FED_DRAIN_TICK:
            live = sorted(fed.members)
            drained = live[int(rng.integers(0, len(live)))]
            fed.drain(drained)
            books["drain"] = drained
        if tick == FED_REJOIN_TICK:
            fed.add(member("gwr0"))
        if tick == FED_CRASH_TICK and not crashed:
            crashed = True
            at_crash = os.path.join(tmp, "federation-at-crash.jrnl")
            shutil.copy(path, at_crash)
            admitted_at_crash = set(subs)
            done_at_crash = [rid for rid, _ in done]
            inflight_at_crash = sorted(
                rid for m in fed.members.values() for rid in m.inflight)
            pre_stats = fed.stats()
            t_crash = time.monotonic()
            journal.abandon()
            del fed, journal
            gc.collect()
            if release is not None:
                release()
            member_ms.clear()
            t0 = time.monotonic()
            fed, info = recover_federation(
                path, member_factory=member, clock=clock,
                renew_period_ns=4 * tick_ns, lease_ttl_ns=6 * tick_ns,
                payloads={rid: journal_payload(reqs, i)
                          for rid, i in subs.items()})
            books["recover_ms"] = (time.monotonic() - t0) * 1e3
            books["recover_member_ms"] = dict(member_ms)
            books["crash_drop_ms"] = (t0 - t_crash) * 1e3
            journal = fed.journal
        for i in arrivals.get(tick, []):
            tenant = f"t{i % FED_TENANTS}"
            r = fed.submit(tenant, journal_payload(reqs, i),
                           cost=reqs[i][1])
            if not r.admitted:
                check(False, f"(b) request {i} admitted ({r.reason})")
            subs[r.rid] = i
            cost_of[tenant] = cost_of.get(tenant, 0.0) + reqs[i][1]
        done.extend(fed.tick())
        if tick == FED_PUSH_TICK:
            # The members' watchers polled the push in this tick.
            adoptions = list(fed.knob_adoptions)
            scales = {n: [b.service_scale for b in m.backends]
                      for n, m in sorted(fed.members.items())}
        clock.advance(tick_ns)
        tick += 1
    journal.close()
    elapsed_s = (clock.now_ns() - start_ns) / SEC

    # -- checks ------------------------------------------------------------
    mine = [a for a in adoptions
            if a["knobs"].get("sched.feedback.tslice_max_us")
            == FED_CANARY_MAX_US]
    want_scale = 1.0 + FED_SWITCH_COST_NS / (FED_CANARY_MAX_US * 1000.0)
    others = {n: s for n, s in scales.items() if n != canary}
    check([a["member"] for a in mine] == [canary]
          and scales.get(canary) == [want_scale]
          and all(s == baseline.get(n, s) for n, s in others.items()),
          f"(b) the push scoped to {canary} was adopted by exactly "
          f"{[a['member'] for a in mine]}; service scale {canary} "
          f"{scales.get(canary)} == [{want_scale}], the others "
          f"{others} unchanged from {baseline}")
    k = books["kill"]
    check(k["casualties"] and k["handoffs"] == len(k["casualties"]),
          f"(b) {k['victim']}'s {len(k['casualties'])} requests were handed "
          f"off ({k['handoffs']} handoffs)")
    view = read_journal(at_crash)
    st = replay(view.records, 6 * tick_ns)
    apply_recover_transform(st)
    check(info.state_digest == state_digest(st)
          and info.rids == admitted_at_crash
          and info.done == set(done_at_crash)
          and sorted(info.requeued_inflight) == inflight_at_crash,
          f"(b) recover_federation: digest {info.state_digest[:16]} == an "
          f"independent replay; rids, done and requeued in flight == the "
          f"client's books at the crash ({len(admitted_at_crash)}, "
          f"{len(done_at_crash)}, {len(inflight_at_crash)})")
    post = sorted(set(subs) - admitted_at_crash)
    check(post and all("-r1-" in rid for rid in post),
          f"(b) the {len(post)} rids admitted after the crash carry -r1- "
          f"({post[:2]})")
    done_rids = [rid for rid, _ in done]
    check(len(done_rids) == len(set(done_rids)) == len(reqs)
          and set(done_rids) == set(subs)
          and set(k["casualties"]) <= set(done_rids),
          f"(b) every admitted rid completed exactly once, the dead "
          f"member's {len(k['casualties'])} among them ({len(done_rids)} "
          f"completions, {len(set(done_rids))} distinct)")
    short = {rid: c["tokens"] for rid, c in done
             if c["tokens"] != reqs[subs[rid]][1]}
    check(not short, f"(b) every completion has its budget's tokens "
                     f"({short})")
    audit = fed.lease_audit()
    bound = {}
    for t, a in sorted(audit.items()):
        q = quotas[t]
        eps = 1e-6 * max(1.0, a["granted"])
        bound[t] = q.burst + q.rate * elapsed_s
        accounted = (a["leased_spent"] + a["held"] + a["deposited"]
                     + a["destroyed"])
        backed = a["leased_spent"] + a["conservative_spent"]
        check(a["granted"] <= a["minted"] + a["deposited"] + eps
              and a["minted"] <= bound[t] + 1e-6
              and accounted <= a["granted"] + eps
              and abs(cost_of.get(t, 0.0) - backed) <= 1e-6 * max(
                  1.0, backed),
              f"(b) {t}: granted {a['granted']:.1f} <= minted "
              f"{a['minted']:.1f} + deposited {a['deposited']:.1f}; minted "
              f"<= burst + rate x {elapsed_s:.3f} s = {bound[t]:.1f}; "
              f"spent+held+deposited+destroyed {accounted:.1f} <= granted; "
              f"admitted cost {cost_of.get(t, 0.0):.0f} == leased + "
              f"conservative {backed:.1f}")
    final = read_journal(path)
    grants = sum(1 for r in final.records if r[1] == Jr.GRANT)
    return dict(canary=canary, adoptions=adoptions, scales=scales,
                baseline=baseline, kill=k, drain=books["drain"],
                info=info, audit=audit, bound=bound, stats=fed.stats(),
                pre_stats=pre_stats, grants=grants,
                recover_ms=books["recover_ms"],
                recover_member_ms=books["recover_member_ms"],
                drop_ms=books["crash_drop_ms"], completions=len(done),
                journal_bytes=os.path.getsize(path), tokens=tokens,
                subs=subs)


def federation_lines(out: dict, card: str) -> None:
    k, st, info = out["kill"], out["stats"], out["info"]
    print(f"  (b) canary push to {out['canary']}: adoptions "
          f"{json.dumps(out['adoptions'])}; service scales {out['scales']} "
          f"(baseline {out['baseline']})", flush=True)
    print(f"  (b) {k['victim']} killed with {len(k['casualties'])} requests "
          f"({k['handoffs']} handed off); {out['drain']} drained, gwr0 "
          f"rejoined; members before the crash "
          f"{json.dumps(out['pre_stats']['members'])}", flush=True)
    per_member = {n: round(v, 1)
                  for n, v in out["recover_member_ms"].items()}
    print(f"  (b) crash: recover_federation {out['recover_ms']:.1f} ms, "
          f"members rebuilt (ms) {json.dumps(per_member)}; drop "
          f"{out['drop_ms']:.1f} ms; {len(info.recovered)} live rids, "
          f"{len(info.requeued_inflight)} requeued in flight, generation "
          f"{info.generation} [{card}]", flush=True)
    minted = {t: round(a["minted"], 1) for t, a in out["audit"].items()}
    print(f"  (b) {out['completions']} completions, handoffs "
          f"{st['handoffs']}, lease renewals (GRANT records) "
          f"{out['grants']}, lease refusals {st['lease_refusals']}; minted "
          f"{minted} vs bound "
          f"{ {t: round(b, 1) for t, b in out['bound'].items()} }; "
          f"journal {out['journal_bytes']} bytes", flush=True)


def chaos_goldens() -> dict:
    """Phase 3j (c): the reference tests' gateway and crash chaos
    scenarios through the port's harnesses, on the card host's CPU,
    held to the reference tests' golden digests."""
    from pbs_tpu_torch.gateway import (run_federation_chaos,
                                       run_gateway_chaos, stock_crash_plan)

    out = {}
    t = time.monotonic()
    g = run_gateway_chaos(workload="mixed", seed=0, n_backends=3,
                          n_tenants=4, ticks=160)
    out["gateway"] = (g, time.monotonic() - t)
    check(g["ok"] and g["trace_digest"] == GOLDEN_GATEWAY_DIGEST,
          f"(c) run_gateway_chaos ok {g['ok']} {g['problems'][:2]}, trace "
          f"digest {g['trace_digest'][:16]} == the golden "
          f"{GOLDEN_GATEWAY_DIGEST[:16]}")
    t = time.monotonic()
    c = run_federation_chaos(workload="mixed", seed=0, n_gateways=3,
                             n_tenants=4, ticks=240,
                             crash_plan=stock_crash_plan(240))
    out["crash"] = (c, time.monotonic() - t)
    check(c["ok"] and c["trace_digest"] == GOLDEN_CRASH_TRACE_DIGEST
          and c["report_digest"] == GOLDEN_CRASH_REPORT_DIGEST
          and c["crash"]["recoveries"] == 2,
          f"(c) run_federation_chaos(crash_plan=stock_crash_plan(240)) ok "
          f"{c['ok']} {c['problems'][:2]}, {c['crash']['recoveries']} "
          f"recoveries, digests {c['trace_digest'][:16]} / "
          f"{c['report_digest'][:16]} == the goldens "
          f"{GOLDEN_CRASH_TRACE_DIGEST[:16]} / "
          f"{GOLDEN_CRASH_REPORT_DIGEST[:16]}")
    return out


def run_journal_path(torch, card):
    """Phase 3j on the card: (a) crash and recover one journaled gateway
    over the flagship bf16 engine, (b) a federation of three such
    members through a member death, a drain and rejoin, a canary push
    and a crash, (c) the chaos harnesses at the reference tests' seeds.
    Returns (a)'s and (b)'s kernel launch counts and routes."""
    import contextlib
    import shutil

    from pbs_tpu_torch.models import (ContinuousBatcher, TransformerConfig,
                                      cast_params, init_params)

    t_phase = time.monotonic()
    cfg = TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16)
    kw = dict(n_slots=ENGINE_SLOTS, prompt_bucket=ENGINE_BUCKET,
              max_len=ENGINE_MAX_LEN, prefix_cache_size=ENGINE_PREFIX)

    def make_params():
        gen = torch.Generator(device="cuda").manual_seed(JOURNAL_SEED)
        params = cast_params(init_params(cfg, gen, device="cuda"),
                             cfg.dtype)
        torch.cuda.synchronize()
        return params

    def make_engine(params):
        eng = ContinuousBatcher(cfg, params, **kw)
        torch.cuda.synchronize()
        return eng

    wrappers = bwd_counts()
    total = {k: 0 for k in KERNELS}
    total_routes = {k: {"wgmma": 0, "simt": 0} for k in KERNELS}

    @contextlib.contextmanager
    def counted(what):
        reset_counts(wrappers)
        yield
        launches, routes = control_launches(wrappers)
        print(f"  ({what}) kernel launches {launches}, by route {routes}",
              flush=True)
        for k in KERNELS:
            total[k] += launches[k]
            for r, n in routes[k].items():
                total_routes[k][r] += n

    tmp, _ = paging_dir("3j")
    try:
        reqs, arrivals = journal_script()
        t = time.monotonic()
        a = crash_and_recover(make_params, make_engine, reqs, arrivals, tmp,
                              JOURNAL_KILL_WINDOW,
                              release=torch.cuda.empty_cache,
                              counted=counted)
        crash_lines(a, card)
        print(f"  (a) wall {time.monotonic() - t:.1f} s", flush=True)
        t = time.monotonic()
        params = make_params()
        with counted("b"):
            b = federation_run(lambda: make_engine(params), reqs, tmp,
                               release=torch.cuda.empty_cache)
        federation_lines(b, card)
        del params
        torch.cuda.empty_cache()
        print(f"  (b) wall {time.monotonic() - t:.1f} s", flush=True)
        c = chaos_goldens()
        for name, (rep, wall) in c.items():
            st = rep["stats"]
            print(f"  (c) {name}: ok {rep['ok']}, admitted {st['admitted']} "
                  f"== completed {st['completed']}, trace digest "
                  f"{rep['trace_digest'][:16]}"
                  + (f", report digest {rep['report_digest'][:16]}, "
                     f"{rep['crash']['recoveries']} recoveries"
                     if "crash" in rep else "")
                  + f", {wall:.2f} s on the card host's CPU", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 3j wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return total, total_routes


# -- phase 3d ----------------------------------------------------------------


def timed_calls(record: list, fn):
    """``fn`` wrapped to append each call's wall time in ms to
    ``record``."""

    def call(*args, **kwargs):
        t = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            record.append((time.monotonic() - t) * 1e3)

    return call


def recording_image(factory, boots: list, losses: dict, sync):
    """An agent's ``"image"`` factory wrapped to time each boot (closed by
    ``sync``) and to record each step's loss, by job name."""

    def boot(partition, job_name, spec):
        t = time.monotonic()
        job = factory(partition, job_name, spec)
        sync()
        boots.append((time.monotonic() - t) * 1e3)
        step_fn = job.step_fn

        def step(state):
            state, metrics = step_fn(state)
            losses.setdefault(job_name, []).append(float(metrics["loss"]))
            return state, metrics

        job.step_fn = step
        return job

    return boot


def tenant_workload(fn, nbytes: int | None = None):
    """An agent workload factory: a Job around a tenant's step ``fn``
    (phase 3's matmul in 3d), ``spec`` giving its max_steps and sched
    params; ``nbytes``, when given, is its declared HBM working set,
    claimed at admission by a partition with a MemoryManager."""

    def create(partition, job_name, spec):
        from pbs_tpu_torch.runtime import Job, SchedParams

        return partition.add_job(Job(
            job_name, step_fn=fn, state=None,
            params=SchedParams(**spec.get("sched", {})),
            max_steps=spec.get("max_steps"), mem_bytes=nbytes))

    return create


def drive_rounds(ctl, done, what: str, limit: int) -> int:
    """Controller rounds of one scheduler round per agent (so the Remus
    pump and the lock-free probes never wait long for the dispatch
    lock) until ``done()``; returns how many ran."""
    rounds = 0
    while not done() and rounds < limit:
        ctl.run_round(max_rounds=1)
        rounds += 1
    check(done(), f"{what}: done in {rounds} cluster rounds (at most "
                  f"{limit})")
    return rounds


def ledger_counters(part, job) -> list:
    """Each context's counters as the partition's ledger holds them."""
    from pbs_tpu_torch.telemetry.counters import counters_dict

    return [counters_dict(part.ledger.snapshot(c.ledger_slot))
            for c in job.contexts]


def carried_state(job) -> dict:
    """What a save record carries of one job, read in process."""
    return dict(sched_count=[c.sched_count for c in job.contexts],
                micro_progress=[c.micro_progress for c in job.contexts],
                counters=[c.counters.tolist() for c in job.contexts],
                steps=job.steps_retired())


def cluster_run(torch, device, warm, image_digest, mm_fn, tmp, digest_of,
                hbm=None) -> dict:
    """Phase 3d (a)-(c): two agents in this process on 127.0.0.1, each a
    credit Partition over ``CudaBackend(device=device)`` with a
    FeedbackPolicy, behind one authenticated Controller. ``train`` boots
    from the warm image at ``warm`` (digest ``image_digest``); ``mm``
    runs ``mm_fn``. (a) placement, rounds and telemetry over RPC; (b)
    a live migration of ``train``, then a pause, page-out and snapshot
    over RPC; (c) Remus replication of ``train``, the holder killed,
    the controller's recovery, and a controller rebuilt from the Store.
    ``hbm()`` reads device bytes in use (None on the host). Returns the
    numbers the phase prints."""
    import statistics

    from pbs_tpu_torch.dist import Agent, Controller, RpcClient
    from pbs_tpu_torch.runtime import Partition
    from pbs_tpu_torch.runtime.paging import page_out_job
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.store import Store
    from pbs_tpu_torch.telemetry import CudaBackend
    from pbs_tpu_torch.telemetry.counters import Counter

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    train_steps, mm_steps = CLUSTER_TRAIN_STEPS, CLUSTER_MM_STEPS
    token = os.urandom(16).hex()
    out: dict = {}
    agents, boots, losses = [], [], {}
    sleeps: dict[str, list] = {}
    op_ms: dict[tuple, list] = {}
    ctl = None
    ctl2 = None
    try:
        for i in range(2):
            name = f"a{i}"
            part = Partition(f"{name}.pool", source=CudaBackend(device=device),
                             scheduler="credit")
            FeedbackPolicy(part)  # held by the partition's timer wheel
            sleeps[name] = []
            part.hooks.on("job-sleep", lambda ev, env, n=name:
                          sleeps[n].append(env["PBST_JOB"]))
            a = Agent(name, partition=part, auth_token=token, device=device,
                      workloads={"mm": tenant_workload(mm_fn)})
            a.workloads["image"] = recording_image(a.workloads["image"],
                                                   boots, losses, sync)
            for op in ("save_job", "restore_job", "remove_job"):
                rec = op_ms[(name, op)] = []
                a.server.ops[op] = timed_calls(rec, a.server.ops[op])
            agents.append(a.start())
        by_name = {a.name: a for a in agents}
        ctl = Controller(auth_token=token)
        for a in agents:
            ctl.add_agent(a.name, a.address)

        # -- (a) the RPC, placement, rounds, telemetry --------------------
        cli = RpcClient(agents[0].address, auth_token=token)
        check(cli.call("ping") == "pong", "(a) an authenticated client "
                                          "pings a0")
        rtt = []
        for _ in range(CLUSTER_PINGS):
            t = time.perf_counter()
            cli.call("ping")
            rtt.append((time.perf_counter() - t) * 1e6)
        rtt.sort()
        out["ping_us"] = (statistics.median(rtt),
                          rtt[math.ceil(0.99 * len(rtt)) - 1])
        t = time.perf_counter()
        res = cli.multicall([("info", {})] * CLUSTER_MULTICALL)
        out["multicall_ms"] = (time.perf_counter() - t) * 1e3
        check(len(res) == CLUSTER_MULTICALL
              and all(r["ok"] and r["result"]["agent"] == "a0" for r in res),
              f"(a) one {CLUSTER_MULTICALL}-entry multicall: every entry ok")
        cli.close()

        ctl.create_job("train", "image", {"path": warm,
                                          "max_steps": train_steps})
        ctl.create_job("mm", "mm", {"max_steps": mm_steps})
        homes = {n: r.members[0].agent for n, r in ctl.jobs.items()}
        check(homes["train"] != homes["mm"],
              f"(a) placement: train on {homes['train']}, mm on "
              f"{homes['mm']} (least loaded first)")
        src = by_name[homes["train"]]
        dst = next(a for a in agents if a is not src)
        out["boot_ms"] = boots[-1]

        def steps(job):
            return ctl.job_steps(job)[job]

        def device_ns(a):
            return sum(int(c.counters[Counter.DEVICE_TIME_NS])
                       for j in a.partition.jobs for c in j.contexts)

        dev0, t0 = [device_ns(a) for a in agents], time.monotonic()
        out["a_rounds"] = drive_rounds(
            ctl, lambda: steps("train") >= 1 and steps("mm") >= 1,
            "(a) train's and mm's first steps", CLUSTER_ROUND_LIMIT)
        out["a_wall_s"] = time.monotonic() - t0
        out["a_device_ms"] = [(device_ns(a) - d) / 1e6
                              for a, d in zip(agents, dev0)]
        out["overlap"] = sum(out["a_device_ms"]) / 1e3 / out["a_wall_s"]
        loss = losses["train"][0]
        check(math.isfinite(loss), f"(a) train's first step: loss {loss:.4f} "
                                   "finite")
        out["loss"] = loss
        words = 0
        for a in agents:
            for j in a.partition.jobs:
                tel = ctl.agents[a.name].client.call("telemetry", job=j.name)
                got = [c["counters"] for c in tel["contexts"]]
                check(got == ledger_counters(a.partition, j),
                      f"(a) telemetry op on {a.name} for {j.name}: every "
                      "counter equal to the partition's ledger snapshot")
                words += sum(len(c) for c in got)
        out["telemetry_words"] = words

        # -- (b) live migration, pause, page-out, snapshot ----------------
        before = carried_state(src.partition.job("train"))
        src_digest = digest_of(src.partition.job("train").state)
        check(src_digest != image_digest,
              f"(b) train trained {before['steps']} step(s) on {src.name}: "
              "its state is no longer the image's")
        n_sleeps = len(sleeps[src.name])
        t = time.monotonic()
        moved = ctl.migrate_job("train", to=dst.name)
        out["migrate_ms"] = dict(
            total=(time.monotonic() - t) * 1e3,
            save=op_ms[(src.name, "save_job")][-1],
            restore=op_ms[(dst.name, "restore_job")][-1],
            boot=boots[-1], remove=op_ms[(src.name, "remove_job")][-1])
        new = dst.partition.job("train")
        check(moved == {"train": dst.name}
              and all(j.name != "train" for j in src.partition.jobs),
              f"(b) migrate_job: train on {dst.name}, gone from {src.name}")
        check(carried_state(new) == before,
              f"(b) carried exactly: sched_count {before['sched_count']}, "
              f"micro_progress {before['micro_progress']}, every counter, "
              f"{before['steps']} step(s)")
        check(len(sleeps[src.name]) == n_sleeps,
              f"(b) the quiesce fired no job-sleep hook on {src.name}")
        check(digest_of(new.state) == image_digest,
              "(b) the restored state is the image's (digest of every "
              "leaf), not the source's last state: device state is not "
              "carried, the job re-boots from its image")
        out["b_rounds"] = drive_rounds(
            ctl, lambda: steps("train") > before["steps"],
            f"(b) train trains on at {dst.name}", CLUSTER_ROUND_LIMIT)
        dcli = ctl.agents[dst.name].client
        dcli.call("pause_job", job="train", subject=ctl.subject)
        check(sleeps[dst.name] == ["train"],
              f"(b) pause_job over RPC fired the job-sleep hook once on "
              f"{dst.name} ({sleeps[dst.name]})")
        paged_digest = digest_of(new.state)
        with dst.dispatch_lock:
            h0 = hbm() if hbm else None
            t = time.monotonic()
            freed = page_out_job(dst.partition, new)
            out["page_out_ms"] = (time.monotonic() - t) * 1e3
            h1 = hbm() if hbm else None
        rows = {r["job"]: r for r in dcli.call("list_jobs")}
        check(freed > 0 and rows["train"]["state"] == "paged",
              f"(b) paged out {freed} B; list_jobs shows "
              f"{rows['train']['state']!r}")
        with dst.dispatch_lock:
            t = time.monotonic()
            rec = dst.snapshot_record("train")
            snap_ms = (time.monotonic() - t) * 1e3
            h2 = hbm() if hbm else None
        check(rec["job"] == "train" and new.paged is not None
              and dst._job_state(new) == "paged" and h2 == h1
              and sleeps[dst.name] == ["train"],
              f"(b) a snapshot_record of the paged job ({snap_ms:.3f} ms) "
              f"left it paged, HBM in use "
              + (f"{h1} B before and {h2} B after (page-out freed "
                 f"{h0 - h1} B)" if hbm else "not measured on the host")
              + ", no hook fired")
        t = time.monotonic()
        dcli.call("unpause_job", job="train", subject=ctl.subject)
        out["page_in_ms"] = (time.monotonic() - t) * 1e3
        check(new.paged is None and digest_of(new.state) == paged_digest,
              "(b) unpause_job paged it back in, every leaf as it was")

        # -- (c) Remus: replicate, kill the holder, recover ----------------
        holder, survivor = dst, src
        peers = ctl.enable_replication("train",
                                       period_s=CLUSTER_REMUS_PERIOD_S,
                                       to=survivor.name)
        check(peers == {"train": survivor.name},
              f"(c) replication of train from {holder.name} to "
              f"{survivor.name}")
        sess = holder.remus["train"]
        capture: list = []
        holder.snapshot_record = timed_calls(capture, holder.snapshot_record)
        t = time.monotonic()
        c_rounds = 0
        while (sess.epochs_committed < CLUSTER_EPOCHS
               and time.monotonic() - t < CLUSTER_EPOCH_WAIT_S):
            # train keeps training, short of its last step, so that the
            # failover below restores a job with a step left to run
            if steps("train") < train_steps - 1:
                ctl.run_round(max_rounds=1)
                c_rounds += 1
            else:
                time.sleep(CLUSTER_REMUS_PERIOD_S / 4)
        out["c_rounds"] = c_rounds
        replica = ctl.agents[survivor.name].client.call(
            "get_replica", job="train", subject=ctl.subject)
        acked_steps = sum(c["counters"][0]
                          for c in replica["saved"]["contexts"])
        out["epochs"] = sess.epochs_committed
        out["epoch_capture_ms"] = statistics.median(capture) if capture \
            else None
        out["record_bytes"] = len(json.dumps(replica["saved"],
                                             separators=(",", ":")))
        check(sess.epochs_committed >= CLUSTER_EPOCHS and sess.failures == 0
              and replica["epoch"] == sess.epochs_committed - 1,
              f"(c) {sess.epochs_committed} epochs acked in "
              f"{time.monotonic() - t:.2f} s (at most "
              f"{CLUSTER_EPOCH_WAIT_S}; {sess.skipped} skipped, "
              f"{sess.failures} failed); the replica on {survivor.name} "
              f"holds epoch {replica['epoch']} at {acked_steps} step(s)")
        store_path = os.path.join(tmp, "cluster.store")
        ctl.save_state(Store(persist_path=store_path))
        saved_map = {n: (r.workload, r.spec, [(m.agent, m.job)
                                              for m in r.members],
                         dict(r.replica_peers))
                     for n, r in ctl.jobs.items()}

        t_kill = time.monotonic()
        holder.stop()
        for j in list(holder.partition.jobs):
            holder.partition.remove_job(j)
        del new
        import gc

        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        beats = 0
        while ctl.agents[holder.name].alive and beats < 2 * \
                ctl.dead_after_missed:
            ctl.heartbeat()
            beats += 1
        moved = ctl.recover()
        restored = survivor.partition.job("train")
        r_steps = restored.steps_retired()
        check(not ctl.agents[holder.name].alive
              and sorted(moved) == ["mm", "train"]
              and ctl.jobs["train"].members[0].agent == survivor.name
              and r_steps >= acked_steps,
              f"(c) {holder.name} dead after {beats} heartbeats; recover() "
              f"moved {sorted(moved)}; train restored on {survivor.name} "
              f"from the replica at {r_steps} step(s) >= the last acked "
              f"epoch's {acked_steps}")
        check(digest_of(restored.state) == image_digest,
              "(c) the failed-over state is the image's: re-booted, as in "
              "a migration")
        drive_rounds(ctl, lambda: steps("train") > r_steps,
                     "(c) train's next step after the failover",
                     CLUSTER_ROUND_LIMIT)
        out["kill_to_step_ms"] = (time.monotonic() - t_kill) * 1e3
        out["failover_boot_ms"] = boots[-1]
        drive_rounds(ctl, lambda: restored.finished(),
                     f"(c) train runs to max_steps {train_steps} on "
                     f"{survivor.name}", CLUSTER_ROUND_LIMIT)
        drive_rounds(ctl, lambda: steps("mm") >= mm_steps,
                     f"(c) mm, re-created from its spec on {survivor.name} "
                     f"(it had no replica), runs its {mm_steps} steps",
                     CLUSTER_ROUND_LIMIT)
        check(steps("train") == train_steps
              and all(math.isfinite(x) for x in losses["train"]),
              f"(c) train retired {train_steps} steps, every loss finite "
              f"({len(losses['train'])} steps run in all, re-runs after "
              "the re-boots included)")
        ctl2 = Controller.load_state(Store(persist_path=store_path),
                                     auth_token=token)
        got_map = {n: (r.workload, r.spec, [(m.agent, m.job)
                                            for m in r.members],
                       dict(r.replica_peers))
                   for n, r in ctl2.jobs.items()}
        check(got_map == saved_map
              and not ctl2.agents[holder.name].alive
              and ctl2.agents[survivor.name].alive,
              f"(c) Controller.load_state over the Store rebuilt the job "
              f"map saved before the kill ({sorted(got_map)}); "
              f"{holder.name} dead, {survivor.name} alive")
        out["losses"] = losses["train"]
        out["steps"] = steps("train")
    finally:
        for c in (ctl, ctl2):
            if c is not None:
                c.close()
        for a in agents:
            a.stop()
    return out


def cluster_lines(out: dict, card: str) -> None:
    m = out["migrate_ms"]
    print(f"  RPC ping round trip p50 {out['ping_us'][0]:.1f} us, p99 "
          f"{out['ping_us'][1]:.1f} us over {CLUSTER_PINGS}; one "
          f"{CLUSTER_MULTICALL}-entry multicall {out['multicall_ms']:.3f} "
          f"ms [{card}]", flush=True)
    print(f"  (a) image boot {out['boot_ms']:.1f} ms; {out['a_rounds']} "
          f"rounds in {out['a_wall_s']:.3f} s; device ms a0 / a1 "
          f"{out['a_device_ms'][0]:.2f} / {out['a_device_ms'][1]:.2f}, "
          f"their sum over the wall {out['overlap']:.3f} (two partitions on one "
          f"card, each quantum closed by a device synchronise); "
          f"{out['telemetry_words']} counter words over RPC [{card}]",
          flush=True)
    print(f"  (b) migration {m['total']:.1f} ms: save {m['save']:.3f}, "
          f"restore {m['restore']:.1f} (of which the image boot "
          f"{m['boot']:.1f}), remove {m['remove']:.3f} ms; page-out "
          f"{out['page_out_ms']:.1f} ms, page-in over RPC "
          f"{out['page_in_ms']:.1f} ms [{card}]", flush=True)
    cap = out["epoch_capture_ms"]
    print(f"  (c) Remus: {out['epochs']} epochs acked, capture "
          + (f"{cap:.3f} ms" if cap is not None else "not timed")
          + f" (median), record {out['record_bytes']} B; kill to "
          f"recovered train's next retired step "
          f"{out['kill_to_step_ms']:.1f} ms (of which the image boot "
          f"{out['failover_boot_ms']:.1f}) [{card}]", flush=True)


def process_federation_checks(tmp) -> dict:
    """Phase 3d (d), on the host's CPU: the process federation (three
    member processes, one SIGKILLed and restarted from its journal, by
    ``run_process_chaos`` and timed on a ``ProcessFederation`` of its
    own), two disarmed runs against the pinned digest, and the cluster
    chaos harness's smoke scenario against the reference's golden."""
    from pbs_tpu_torch.faults import run_chaos
    from pbs_tpu_torch.gateway import (ProcessFederation, TenantQuota,
                                       run_process_chaos,
                                       stock_process_kill_plan)
    from pbs_tpu_torch.utils.clock import MS, VirtualClock

    out = {}
    t = time.monotonic()
    r = run_process_chaos(**PROCFED_KILL_KW,
                          kill_plan=stock_process_kill_plan(
                              PROCFED_KILL_KW["ticks"]))
    out["kill_s"] = time.monotonic() - t
    kills, rec = r["process"]["kills"], r["process"]["recoveries"]
    check(r["ok"] and len(kills) == 1 and len(rec) == 1
          and r["process"]["members"][kills[0]["member"]]["restarts"] == 1,
          f"(d) run_process_chaos, {PROCFED_KILL_KW['n_gateways']} member "
          f"processes: {kills[0]['member'] if kills else '?'} SIGKILLed at "
          f"tick {kills[0]['tick'] if kills else '?'}, restarted once, "
          f"recovered from its journal (generation "
          f"{rec[0]['generation'] if rec else '?'}); every invariant holds "
          f"{r['problems'][:2]}")
    digests = []
    for _ in range(2):
        t = time.monotonic()
        d = run_process_chaos(**PROCFED_DISARMED_KW)
        digests.append((d["ok"], d["digest"], time.monotonic() - t))
    check(all(ok and dg == PROCFED_DISARMED_DIGEST
              for ok, dg, _ in digests),
          f"(d) two disarmed runs: digests {digests[0][1][:16]} and "
          f"{digests[1][1][:16]} == the host twin's "
          f"{PROCFED_DISARMED_DIGEST[:16]}")
    out["disarmed_s"] = [s for _, _, s in digests]

    names = [f"gw{i}" for i in range(PROCFED_KILL_KW["n_gateways"])]
    clock = VirtualClock()
    fed = ProcessFederation(os.path.join(tmp, "procfed"), names,
                            clock=clock, seed=PROCFED_KILL_KW["seed"],
                            heartbeat_ns=8 * MS, restart_backoff_ns=4 * MS)
    try:
        t = time.monotonic()
        fed.start()
        out["spawn_ms"] = (time.monotonic() - t) * 1e3
        fed.register_tenant("t0", TenantQuota(rate=2000.0, burst=20.0))
        for _ in range(8):
            fed.submit("t0", cost=1)
            clock.advance(MS)
            fed.tick()
        durable = set(fed.durable_rids)
        victim = fed.ring.lookup("t0")
        t = time.monotonic()
        fed.kill9(victim)
        n = 0
        while not (fed.links[victim].recovered_from_journal
                   and fed.sups[victim].state == "live") and n < 1000:
            clock.advance(MS)
            fed.tick()
            n += 1
        out["recover_ms"] = (time.monotonic() - t) * 1e3
        out["recover_ticks"] = n
        for _ in range(1000):
            if not fed.busy():
                break
            clock.advance(MS)
            fed.tick()
        check(fed.links[victim].recovered_from_journal and durable
              and durable <= fed.completed_rids,
              f"(d) ProcessFederation: {len(names)} members ready in "
              f"{out['spawn_ms']:.1f} ms; {victim} SIGKILLed and back from "
              f"its journal in {out['recover_ms']:.1f} ms ({n} ticks); all "
              f"{len(durable)} durably acked requests completed")
    finally:
        fed.stop()
    t = time.monotonic()
    c = run_chaos(workload="stable", seed=0, n_agents=2, n_tenants=2,
                  rounds=2)
    out["chaos_s"] = time.monotonic() - t
    check(c["ok"] and c["trace_digest"] == GOLDEN_SMOKE_DIGEST,
          f"(d) run_chaos's smoke scenario: ok {c['ok']} {c['problems'][:2]}, "
          f"trace digest {c['trace_digest'][:16]} == the golden "
          f"{GOLDEN_SMOKE_DIGEST[:16]}")
    return out


def run_cluster_path(torch, gen, card):
    """Phase 3d on the card: the cluster control plane over the flagship
    training image and phase 3's matmul tenant (build in a git-ignored
    scratch directory, removed at the end), then the process federation
    and the agent chaos harness on the card host's CPU. Returns the
    kernel launch counts and routes of (a)-(c)."""
    import shutil

    t_phase = time.monotonic()
    cfg = train_config(torch)
    tmp, free = paging_dir("3d")
    try:
        need = 12 * cfg.num_params() + 4 * PAGING_CORPUS_TOKENS
        check(free >= need,
              f"disk: {free / 1e9:.1f} GB free for 3d's images, needs "
              f"{need / 1e9:.1f} GB")
        paths, image_digest, _, _ = build_images(torch, cfg, tmp)
        mm_fn = mm_tenant(torch, gen)
        wrappers = bwd_counts()
        # Each kernel has one launching tenant (2.1-2.3 train, 2.4 mm) and
        # a tenant lives on one agent at a time, so no count is bumped
        # from two agent threads at once.
        reset_counts(wrappers)
        t = time.monotonic()
        out = cluster_run(torch, "cuda", paths["warm"], image_digest, mm_fn,
                          tmp, lambda s: state_digest(torch, s),
                          hbm=torch.cuda.memory_allocated)
        launches, routes = control_launches(wrappers)
        cluster_lines(out, card)
        print(f"  (a)-(c) wall {time.monotonic() - t:.1f} s; kernel "
              f"launches {launches}, by route {routes}", flush=True)
        for k in KERNELS:
            n = launches[k]
            check(n > 0 and routes[k] == {"wgmma": n, "simt": 0},
                  f"{k}: {n} launches on the 3d path, every one on the "
                  f"tensor-core route")
        d = process_federation_checks(tmp)
        print(f"  (d) run_process_chaos with a SIGKILL {d['kill_s']:.2f} s, "
              f"disarmed {d['disarmed_s'][0]:.2f} / {d['disarmed_s'][1]:.2f} "
              f"s; spawn to ready {d['spawn_ms']:.1f} ms for "
              f"{PROCFED_KILL_KW['n_gateways']} members; SIGKILL to "
              f"restarted and recovered {d['recover_ms']:.1f} ms; run_chaos "
              f"smoke {d['chaos_s']:.2f} s, on the card host's CPU [{card}]",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), f"3d's files removed ({tmp})")
    print(f"  phase 3d wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, routes


# -- phase 3a ----------------------------------------------------------------


def autopilot_script():
    """Phase 3a (a)'s script: 3j's 24 requests AP_REPEATS times over, 8
    at tick 0 and then one a tick, so that arrivals go on through the
    guard window."""
    reqs, _ = engine_script()
    reqs = list(reqs) * AP_REPEATS
    arrivals = {0: list(range(ENGINE_FIRST))}
    for i in range(ENGINE_FIRST, len(reqs)):
        arrivals[1 + i - ENGINE_FIRST] = [i]
    return reqs, arrivals


def autopilot_tenant(i: int, n: int) -> str:
    """Request i's tenant: a chat budget to an even (interactive) tenant,
    a bulk one to an odd (batch) tenant, round robin over the three."""
    k = i % (FED_TENANTS // 2)
    return f"t{2 * k + (0 if n <= GW_CHAT_MAX_NEW else 1)}"


def loop_modules():
    """The port's modules phase 3a (a) builds its federation and loop
    from (a host test passes another package's in their place)."""
    import types

    import pbs_tpu_torch.autopilot as autopilot
    import pbs_tpu_torch.gateway as gateway
    from pbs_tpu_torch.knobs import channel, profile
    from pbs_tpu_torch.utils import clock

    return types.SimpleNamespace(autopilot=autopilot, gateway=gateway,
                                 channel=channel, profile=profile,
                                 clock=clock)


def applied_view(fed) -> dict:
    return {n: dict(m.applied_knobs) for n, m in sorted(fed.members.items())}


def autopilot_engine_loop(mods, make_engine, reqs, arrivals, tmp) -> dict:
    """Phase 3a (a): FED_MEMBERS ``FederatedGateway`` members, each a
    Gateway over its own engine (``make_engine``), the script to
    FED_TENANTS tenants on a virtual clock of AP_TICK_NS ticks, and an
    ``Autopilot`` over a knob channel in ``tmp`` at the reference
    harness's cadence. Keeps the window the shadow search read, every
    member's adopted knobs through the guard and every completion's
    tokens. Every check raises ``Failed``; returns the books."""
    tick_ns = AP_TICK_NS
    clock = mods.clock.VirtualClock()
    tokens: dict = {}
    fed = mods.gateway.FederatedGateway(
        [federation_member(make_engine, f"gw{i}", clock, tokens, 0,
                           gateway=mods.gateway)
         for i in range(FED_MEMBERS)],
        clock=clock, renew_period_ns=4 * tick_ns, lease_ttl_ns=6 * tick_ns)
    for j in range(FED_TENANTS):
        fed.register_tenant(f"t{j}", mods.gateway.TenantQuota(
            rate=GW_RATE, burst=GW_BURST, weight=256,
            slo="interactive" if j % 2 == 0 else "batch",
            max_queued=GW_MAX_QUEUED))
    ticks = max(arrivals) + 1
    writer = mods.channel.KnobChannel.create(
        os.path.join(tmp, "autopilot.led"))
    cfg = mods.autopilot.AutopilotConfig(
        min_record_ns=(ticks // 3) * tick_ns,
        guard_window_ns=(ticks // 3) * tick_ns, quick=True, max_rounds=1)
    pilot = mods.autopilot.Autopilot(fed, writer, config=cfg)
    subs, done, guard, pilot_ms = {}, [], [], []
    window = baseline = None
    tick = 0
    while tick < ticks or fed.busy() or pilot.state != "done":
        if tick >= 50 * ticks:
            check(False, f"(a) the loop ends (tick {tick}, pilot "
                         f"{pilot.state}, busy {fed.busy()})")
        for i in arrivals.get(tick, []):
            n = reqs[i][1]
            r = fed.submit(autopilot_tenant(i, n), journal_payload(reqs, i),
                           cost=n)
            check(r.admitted, f"(a) request {i} admitted ({r.reason})")
            subs[r.rid] = i
        done.extend(fed.tick())
        view = applied_view(fed)
        if pilot.state == "canary":
            guard.append(view)
        n_hist = len(pilot.history)
        t = time.monotonic()
        pilot.tick()
        pilot_ms.append((time.monotonic() - t) * 1e3)
        if any(e["event"] == "propose" for e in pilot.history[n_hist:]):
            # Nothing was submitted since the pilot read its recorder:
            # this is the window its search read.
            window, baseline = pilot.recorder.window(), view
        clock.advance(tick_ns)
        tick += 1
    done.extend(fed.tick())  # the members adopt the decision's push

    events = [e["event"] for e in pilot.history]
    propose, decision = pilot.history[0], pilot.history[-1]
    check(window is not None and events[0] == "propose"
          and decision["event"] in ("promote", "rollback", "hold"),
          f"(a) the loop proposed and decided: {events}")
    check(window.digest() == propose["window_digest"],
          f"(a) the recorder's window {window.digest()[:16]} is the one the "
          f"search read ({propose['window_digest'][:16]})")
    canary = pilot.history[1]["members"] if events[1:2] == ["canary"] else []
    cand = mods.profile.params_to_knobs(cfg.policy, propose["candidate"])
    moved = sorted({n for v in guard for n in v
                    if n not in canary and v[n] != baseline.get(n)})
    held = all(v[c].get(k) == x for v in guard for c in canary
               for k, x in cand.items())
    check(not moved and held,
          f"(a) through the {len(guard)}-tick guard only the canary "
          f"{canary}'s applied knobs moved (others that moved: {moved}), "
          f"and it held the candidate {propose['candidate']}")
    final = applied_view(fed)
    want = cand if decision["event"] == "promote" else dict(
        pilot.canary.reference)
    off = {n: {k: (v.get(k), x) for k, x in want.items() if v.get(k) != x}
           for n, v in final.items()}
    off = {n: d for n, d in off.items() if d}
    check(not off, f"(a) after the {decision['event']} every member is on "
                   f"the {'candidate' if decision['event'] == 'promote' else 'reference'}"
                   f" (off: {off})")
    done_rids = [rid for rid, _ in done]
    short = {subs[rid]: c["tokens"] for rid, c in done
             if c["tokens"] != reqs[subs[rid]][1]}
    check(not fed.busy() and fed.admitted == fed.completed == len(reqs)
          and sorted(done_rids) == sorted(subs) and not short,
          f"(a) after the drain admitted {fed.admitted} == completed "
          f"{fed.completed} == {len(reqs)} requests, each once, each with "
          f"its budget's tokens ({short})")
    report = pilot.report()
    report["stats"] = {"admitted": fed.admitted, "completed": fed.completed,
                       "drained": not fed.busy()}
    return dict(report=report, window=window, canary=canary,
                decision=decision, propose=propose, final=final,
                guard_ticks=len(guard), ticks=tick, pilot_ms=pilot_ms,
                scales={n: [b.service_scale for b in m.backends]
                        for n, m in sorted(fed.members.items())},
                tokens={i: tokens[rid] for rid, i in subs.items()})


def autopilot_search_check(mods, out, tmp) -> float:
    """(a)'s window saved and loaded back keeps its digest, and the
    shadow search on the loaded window gives the loop's proposal, key
    for key. Returns the search's wall ms."""
    path = os.path.join(tmp, "window.jsonl")
    out["window"].save(path)
    back = mods.autopilot.ShadowWindow.load(path)
    check(back.digest() == out["window"].digest(),
          f"(a) the window saved and loaded keeps its digest "
          f"{back.digest()[:16]}")
    p = out["propose"]
    t = time.monotonic()
    again = mods.autopilot.shadow_search(back, live_params=p["live"],
                                         policy=p["policy"], quick=True)
    ms = (time.monotonic() - t) * 1e3
    differ = sorted(k for k in again if again[k] != p.get(k))
    check(not differ, f"(a) shadow_search on the loaded window reproduces "
                      f"the loop's proposal (keys that differ: {differ})")
    return ms


class CardKnobObserver:
    """Phase 3a (b)'s card partition as an observer of the pilot's knob
    channel: a ``KnobWatcher`` keyed as ``member`` hands what it delivers
    to the partition's ``FeedbackPolicy`` (``fb.apply_knobs``), and after
    each federation tick the partition runs ``quanta`` quanta. Keeps the
    adoptions with their generations and, per band segment, the quanta,
    the wall time and each tenant's device ns, steps and picks."""

    def __init__(self, part, fb, jobs: dict, member: str, quanta: int):
        from pbs_tpu_torch.knobs.profile import PARAM_KNOBS

        self.part, self.fb, self.jobs = part, fb, jobs
        self.member, self.quanta = member, quanta
        self.adoptable = {k for m in PARAM_KNOBS.values() for k in m.values()}
        self.adoptions: list = []
        self.segments: list = []
        self._new_segment()

    def _new_segment(self) -> None:
        self.segments.append({
            "band": [self.fb.min_us, self.fb.max_us], "quanta": 0,
            "wall_s": 0.0, **{k: {n: 0 for n in self.jobs}
                              for k in ("dev_ns", "steps", "picks")}})

    def attach(self, path: str) -> None:
        from pbs_tpu_torch.knobs.channel import KnobChannel, KnobWatcher

        self.reader = KnobChannel.attach(path)
        self.watcher = KnobWatcher(self.reader, member=self.member)
        self.watcher.add(self._adopt)
        self.watcher.prime()

    def _adopt(self, changed: dict, _values: dict) -> None:
        knobs = {k: changed[k] for k in sorted(changed)
                 if k in self.adoptable}
        if not knobs:
            return
        band = (self.fb.min_us, self.fb.max_us)
        self.fb.apply_knobs(changed)
        self.adoptions.append({"generation": self.reader.generation,
                               "knobs": knobs})
        if (self.fb.min_us, self.fb.max_us) != band:
            self._new_segment()

    def _books(self) -> dict:
        from pbs_tpu_torch.telemetry import Counter

        return {n: (int(j.contexts[0].counters[Counter.DEVICE_TIME_NS]),
                    j.steps_retired()) for n, j in self.jobs.items()}

    def after_tick(self) -> None:
        from pbs_tpu_torch.obs.trace import Ev

        self.watcher.poll()
        seg = self.segments[-1]
        before = self._books()
        t = time.monotonic()
        seg["quanta"] += self.part.run(max_rounds=self.quanta)
        seg["wall_s"] += time.monotonic() - t
        for n, (dev, steps) in self._books().items():
            seg["dev_ns"][n] += dev - before[n][0]
            seg["steps"][n] += steps - before[n][1]
        slot = {j.contexts[0].ledger_slot: n for n, j in self.jobs.items()}
        for r in self.part.drain_traces(1 << 16).tolist():
            if r[1] == int(Ev.SCHED_PICK) and r[2] in slot:
                seg["picks"][slot[r[2]]] += 1


def autopilot_demo_loop(seed, ticks, pathological, tmp, observer=None,
                        tick_ns=1_000_000):
    """``run_autopilot_demo``'s loop, statement for statement, with
    ``observer`` beside it: ``observer.attach(path)`` once the pilot's
    channel exists, ``observer.after_tick()`` after each ``fed.tick()`` +
    ``pilot.tick()``. Also books the generation at which member
    AP_CANARY_MEMBER adopted each push and the generation of each
    decision's push. Returns (report, member adoptions, pushes)."""
    from pbs_tpu_torch.autopilot import Autopilot, AutopilotConfig
    from pbs_tpu_torch.faults import injector as faults_mod
    from pbs_tpu_torch.faults.plan import FaultPlan, FaultSpec
    from pbs_tpu_torch.gateway.chaos import (_federation_member,
                                             catalog_arrivals, draw_arrival,
                                             quota_for)
    from pbs_tpu_torch.gateway.federation import FederatedGateway
    from pbs_tpu_torch.knobs.channel import KnobChannel
    from pbs_tpu_torch.sim.workload import build_workload
    from pbs_tpu_torch.utils.clock import VirtualClock

    plan = FaultPlan(seed=seed, specs=(
        (FaultSpec("autopilot.candidate", "pathological", p=1.0,
                   times=1),) if pathological else ()))
    faults_mod.install(plan)
    member_adoptions, pushes = [], []
    try:
        clock = VirtualClock()
        members = [_federation_member(f"gw{i}", i, clock, tick_ns, seed,
                                      n_backends=2, n_tenants=4)
                   for i in range(3)]
        fed = FederatedGateway(members, clock=clock,
                               renew_period_ns=4 * tick_ns,
                               lease_ttl_ns=6 * tick_ns)
        tenants = build_workload("mixed", seed=seed, n_tenants=4)
        for t in tenants:
            fed.register_tenant(t.name, quota_for(t.name, t.slo,
                                                  t.params.weight))
        arrivals = catalog_arrivals(tenants, seed, tag=17)
        path = os.path.join(tmp, f"knobs-{int(pathological)}.led")
        writer = KnobChannel.create(path)
        cfg = AutopilotConfig(min_record_ns=(ticks // 3) * tick_ns,
                              guard_window_ns=(ticks // 3) * tick_ns,
                              quick=True, max_rounds=1)
        pilot = Autopilot(fed, writer, config=cfg)
        seen = 0

        def book() -> None:
            nonlocal seen
            for a in fed.knob_adoptions[seen:]:
                if a["member"] == AP_CANARY_MEMBER:
                    member_adoptions.append({
                        "generation": writer.generation,
                        "knobs": dict(sorted(a["knobs"].items()))})
            seen = len(fed.knob_adoptions)

        book()
        if observer is not None:
            observer.attach(path)

        def step() -> None:
            fed.tick()
            book()
            n_hist = len(pilot.history)
            pilot.tick()
            for e in pilot.history[n_hist:]:
                if e["event"] in ("canary", "promote", "rollback"):
                    pushes.append((e["event"], writer.generation))
            if observer is not None:
                observer.after_tick()
            clock.advance(tick_ns)

        for tick in range(int(ticks)):
            for t in tenants:
                fire, cost = draw_arrival(t, arrivals[t.name])
                if fire:
                    fed.submit(t.name, {"tick": tick}, cost=cost)
            step()
        for _ in range(int(ticks) * 6):
            if not fed.busy():
                break
            step()
        report = pilot.report()
        report["stats"] = {
            "admitted": fed.admitted, "completed": fed.completed,
            "drained": not fed.busy(),
        }
        report["pathological"] = bool(pathological)
        report["seed"] = int(seed)
        report["ticks"] = int(ticks)
        return report, member_adoptions, pushes
    finally:
        faults_mod.uninstall()


def autopilot_card_checks(what, report, member_adoptions, pushes,
                          observer, pathological) -> None:
    """(b)'s checks: the loop's report is ``run_autopilot_demo``'s for
    the same arguments, byte for byte; the canary sat on
    AP_CANARY_MEMBER; the card partition adopted what that member
    adopted at the same generations, and each decision's band at its
    push's generation."""
    from pbs_tpu_torch.autopilot import (PATHOLOGICAL_PARAMS,
                                         run_autopilot_demo)
    from pbs_tpu_torch.knobs.profile import params_to_knobs

    want = run_autopilot_demo(seed=report["seed"], ticks=report["ticks"],
                              pathological=pathological)
    check(json.dumps(report, sort_keys=True) == json.dumps(want,
                                                           sort_keys=True),
          f"({what}) the loop's report == run_autopilot_demo(seed="
          f"{report['seed']}, ticks={report['ticks']}, pathological="
          f"{pathological})'s, byte for byte")
    events = [e["event"] for e in report["history"]]
    canary = [e["members"] for e in report["history"]
              if e["event"] == "canary"]
    check(all(m == [AP_CANARY_MEMBER] for m in canary),
          f"({what}) the canary sat on {canary} == [[{AP_CANARY_MEMBER!r}]]")
    check(observer.adoptions == member_adoptions,
          f"({what}) the card partition adopted "
          f"{[(a['generation'], len(a['knobs'])) for a in observer.adoptions]}"
          f" == what {AP_CANARY_MEMBER} adopted (generation, knobs): "
          f"{[(a['generation'], len(a['knobs'])) for a in member_adoptions]}")
    gens = {a["generation"]: a["knobs"] for a in observer.adoptions}
    bands = [s["band"] for s in observer.segments]
    if pathological:
        patho = params_to_knobs("feedback", PATHOLOGICAL_PARAMS)
        (_, g_canary), (_, g_rollback) = pushes
        check(events == ["propose", "canary", "rollback"]
              and bands == [bands[0], [10, 10], bands[0]]
              and g_canary in gens
              and all(patho.get(k) == v for k, v in gens[g_canary].items())
              and gens[g_canary].get("sched.feedback.tslice_max_us") == 10
              and gens.get(g_rollback, {}).get(
                  "sched.feedback.tslice_max_us") == bands[0][1],
              f"({what}) the card partition took the pathological band at "
              f"the canary's generation {g_canary} and the reference band "
              f"back at the rollback's {g_rollback}: bands {bands}, pushes "
              f"{pushes}")
    else:
        check(events[0] == "propose" and "rollback" not in events,
              f"({what}) no rollback without the injection: {events}; "
              f"bands {bands}, pushes {pushes}")


def segment_lines(what, observer, switch_cost_ns, card) -> list:
    """(b)'s figures per band segment; returns them."""
    rows = []
    for s in observer.segments:
        dev = sum(s["dev_ns"].values())
        host_ms = ((s["wall_s"] * 1e9 - dev) / max(1, s["quanta"])) / 1e6
        mm_q = s["picks"].get("mm", 0)
        row = {"band": s["band"], "quanta": s["quanta"],
               "mm_steps_per_quantum": (s["steps"].get("mm", 0) / mm_q
                                        if mm_q else None),
               "host_ms_per_quantum": host_ms,
               "device_share": {n: (d / dev if dev else None)
                                for n, d in s["dev_ns"].items()},
               "picks": dict(s["picks"]),
               "switch_cost_ratio": host_ms * 1e6 / switch_cost_ns}
        rows.append(row)
        print(f"  ({what}) band {s['band']} us: {s['quanta']} quanta, mm "
              f"{s['steps'].get('mm', 0)} steps in {mm_q} picks ("
              f"{row['mm_steps_per_quantum']} a quantum), score "
              f"{s['steps'].get('score', 0)} steps in "
              f"{s['picks'].get('score', 0)} picks; wall "
              f"{s['wall_s'] * 1e3:.1f} ms, device {dev / 1e6:.1f} ms; "
              f"host {host_ms:.4f} ms a quantum = "
              f"{row['switch_cost_ratio']:.3f} x autopilot.switch_cost_ns "
              f"({switch_cost_ns} ns); device share "
              f"{json.dumps({n: round(v, 4) if v is not None else None for n, v in row['device_share'].items()})}"
              f" [{card}]", flush=True)
    return rows


def autopilot_chaos_checks() -> dict:
    """Phase 3a (c): the autopilot chaos gate and the plain federation
    run, on the host's CPU, against the reference tests' goldens."""
    from pbs_tpu_torch.gateway import run_federation_chaos

    t = time.monotonic()
    r = run_federation_chaos(**AP_CHAOS_KW, autopilot=True)
    ap_s = time.monotonic() - t
    hist = r["autopilot"]["history"]
    ref = r["autopilot"]["status"]["reference"]
    off = sorted(n for n, a in r["autopilot"]["members"].items()
                 if any(a.get(k) != v for k, v in ref.items()))
    check(r["ok"] and r["trace_digest"] == GOLDEN_AP_TRACE_DIGEST
          and r["report_digest"] == GOLDEN_AP_REPORT_DIGEST,
          f"(c) run_federation_chaos(autopilot=True) ok {r['ok']} "
          f"{r['problems'][:2]}, digests {r['trace_digest'][:16]} / "
          f"{r['report_digest'][:16]} == the goldens "
          f"{GOLDEN_AP_TRACE_DIGEST[:16]} / {GOLDEN_AP_REPORT_DIGEST[:16]}")
    check([e["event"] for e in hist] == ["propose", "canary", "rollback"]
          and hist[0]["injected"] and not off,
          f"(c) the injected candidate rolled back "
          f"({[e['event'] for e in hist]}, reason "
          f"{hist[-1].get('reason')}) and every member is on the reference "
          f"(off: {off})")
    t = time.monotonic()
    p = run_federation_chaos(**AP_CHAOS_KW)
    plain_s = time.monotonic() - t
    check(p["ok"] and "autopilot" not in p
          and p["trace_digest"] == GOLDEN_FED_TRACE_DIGEST
          and p["report_digest"] == GOLDEN_FED_REPORT_DIGEST,
          f"(c) the plain federation run's digests {p['trace_digest'][:16]}"
          f" / {p['report_digest'][:16]} == their pre-autopilot goldens")
    return dict(report=r, ap_s=ap_s, plain_s=plain_s)


def spawn_probe(_):
    """A spawn worker's start: load the scenario plane; returns the
    seconds it took and whether torch came with it."""
    t = time.monotonic()
    import pbs_tpu_torch.scenarios.score  # noqa: F401

    return time.monotonic() - t, "torch" in sys.modules


def scenario_checks() -> dict:
    """Phase 3a (d): the demo hunt on one and two spawn workers, the
    shipped corpus replayed at its golden digests, a what-if on each
    entry, and what a spawn worker costs to start; on the host's CPU."""
    import multiprocessing as mp

    from pbs_tpu_torch.scenarios import (HuntConfig, corpus_paths, hunt,
                                         load_entry, replay_corpus,
                                         whatif_entry)

    out = {"hunt_s": {}}
    for workers in (1, 2):
        t = time.monotonic()
        h = hunt(HuntConfig.demo(), workers=workers)
        out["hunt_s"][workers] = time.monotonic() - t
        check(h["archive_digest"] == AP_HUNT_DIGEST,
              f"(d) hunt(HuntConfig.demo(), workers={workers}): archive of "
              f"{len(h['archive'])}, digest {h['archive_digest'][:16]} == "
              f"{AP_HUNT_DIGEST[:16]}")
    t = time.monotonic()
    rep = replay_corpus(check=True)
    out["replay_s"] = time.monotonic() - t
    check(rep["ok"] and rep["entries"] >= 3,
          f"(d) replay_corpus(check=True) over the port's corpus: ok "
          f"{rep['ok']}, {rep['entries']} entries, corpus digest "
          f"{rep['corpus_digest'][:16]}")
    t = time.monotonic()
    out["whatif"] = [whatif_entry(load_entry(p)) for p in corpus_paths()]
    out["whatif_s"] = time.monotonic() - t
    check(all(w["proposal"]["window_digest"] == w["window_digest"]
              for w in out["whatif"]),
          f"(d) whatif_entry on each of {len(out['whatif'])} entries")
    t = time.monotonic()
    with mp.get_context("spawn").Pool(2) as pool:
        probes = pool.map(spawn_probe, range(2))
    out["spawn_s"] = time.monotonic() - t
    out["spawn_import_s"] = [s for s, _ in probes]
    check(not any(torch_in for _, torch_in in probes),
          f"(d) a spawn worker loads the scenario plane without torch "
          f"({probes})")
    return out


def run_autopilot_path(torch, gen, cfg, params, a_tokens, card):
    """Phase 3a on the card: (a) the closed loop over three members on
    the bf16 flagship engine (3s's weights); (b) run_autopilot_demo's
    loop, both ways, steering a card Partition of score (2.1) and mm
    (2.4); (c) the autopilot chaos gate; (d) the scenario frontier.
    Returns (b)'s kernel launch counts and routes."""
    import shutil

    from pbs_tpu_torch.knobs import default as knob_default
    from pbs_tpu_torch.models import ContinuousBatcher
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import CudaBackend

    t_phase = time.monotonic()
    kw = dict(n_slots=ENGINE_SLOTS, prompt_bucket=ENGINE_BUCKET,
              max_len=ENGINE_MAX_LEN, prefix_cache_size=ENGINE_PREFIX)

    def make_engine():
        return ContinuousBatcher(cfg, params, **kw)

    mods = loop_modules()
    tmp, _ = paging_dir("3a")
    try:
        # -- (a) ---------------------------------------------------------
        reqs, arrivals = autopilot_script()
        t = time.monotonic()
        a = autopilot_engine_loop(mods, make_engine, reqs, arrivals, tmp)
        torch.cuda.synchronize()
        a_wall = time.monotonic() - t
        search_ms = autopilot_search_check(mods, a, tmp)
        want = {k: a_tokens[k % ENGINE_REQUESTS] for k in range(len(reqs))}
        ties = compare_tokens(torch, cfg, params, reqs, a["tokens"], want,
                              "(a)")
        st, d, p = a["report"]["status"], a["decision"], a["propose"]
        print(f"  (a) {a['ticks']} ticks in {a_wall:.2f} s wall; recorded "
              f"{st['recorded_arrivals']} arrivals, dropped "
              f"{st['dropped_arrivals']}; window {len(a['window'].arrivals)}"
              f" arrivals, digest {a['window'].digest()[:16]}, class "
              f"{p['workload']}; shadow search {search_ms:.1f} ms wall; "
              f"pilot tick p50/max "
              f"{statistics.median(a['pilot_ms']):.3f}/"
              f"{max(a['pilot_ms']):.1f} ms [{card}]", flush=True)
        print(f"  (a) proposal margin_x1e6 {p['margin_x1e6']} (candidate "
              f"{p['candidate_score_x1e6']} vs live {p['live_score_x1e6']},"
              f" candidate {json.dumps(p['candidate'], sort_keys=True)}); "
              f"decision {d['event']}"
              + (f" ({d['reason']})" if "reason" in d else "")
              + f" on canary {a['canary']} after a {a['guard_ticks']}-tick "
              f"guard; burns per tenant {json.dumps(d.get('burns', {}))}; "
              f"service scales {a['scales']}; token divergences at "
              f"near-ties {len(ties)}", flush=True)

        # -- (b) ---------------------------------------------------------
        wrappers = bwd_counts()
        reset_counts(wrappers)
        switch_ns = int(knob_default("autopilot.switch_cost_ns"))
        b_rows = {}
        for pathological in (True, False):
            what = f"b {'pathological' if pathological else 'healthy'}"
            jobs = {}
            for name, fn in (("score", scoring_tenant(torch, gen, cfg,
                                                      params)),
                             ("mm", mm_tenant(torch, gen))):
                fn(None)  # warm outside the partition
                jobs[name] = Job(name, step_fn=fn, params=SchedParams(
                    weight=AP_CARD_WEIGHTS[name]))
            torch.cuda.synchronize()
            part = Partition(f"autopilot-{int(pathological)}",
                             source=CudaBackend(), scheduler="credit")
            check_native(part)
            fb = FeedbackPolicy(part)
            for job in jobs.values():
                part.add_job(job)
            obs = CardKnobObserver(part, fb, jobs, AP_CANARY_MEMBER,
                                   AP_CARD_QUANTA)
            t = time.monotonic()
            report, member_adoptions, pushes = autopilot_demo_loop(
                AP_DEMO_SEED, AP_DEMO_TICKS, pathological, tmp, obs)
            torch.cuda.synchronize()
            wall = time.monotonic() - t
            autopilot_card_checks(what, report, member_adoptions, pushes,
                                  obs, pathological)
            for name, job in jobs.items():
                check(job.error is None and job.steps_retired() > 0,
                      f"({what}) {name}: {job.steps_retired()} steps, no "
                      f"fault ({job.error})")
            print(f"  ({what}) decisions {report['status']['decisions']}, "
                  f"pushes {pushes}, card adoptions "
                  f"{[(x['generation'], x['knobs'].get('sched.feedback.tslice_max_us')) for x in obs.adoptions]}"
                  f" (generation, max_us); {wall:.2f} s wall", flush=True)
            b_rows[what] = segment_lines(what, obs, switch_ns, card)
            del jobs, part, fb, obs
        launches, routes = control_launches(wrappers)
        for k in ("flash_fwd", "instrumented_matmul"):
            n = launches[k]
            check(n > 0 and routes[k] == {"wgmma": n, "simt": 0},
                  f"(b) {k}: {n} launches, every one on the tensor-core "
                  f"route ({routes[k]})")
        print(f"  (b) kernel launches {launches}, by route {routes}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), f"3a's files removed ({tmp})")

    # -- (c), (d) ---------------------------------------------------------
    c = autopilot_chaos_checks()
    print(f"  (c) autopilot chaos gate {c['ap_s']:.2f} s, plain federation "
          f"{c['plain_s']:.2f} s, on the card host's CPU [{card}]",
          flush=True)
    dd = scenario_checks()
    print(f"  (d) demo hunt {dd['hunt_s'][1]:.2f} s on 1 worker, "
          f"{dd['hunt_s'][2]:.2f} s on 2; corpus replay "
          f"{dd['replay_s']:.2f} s; what-ifs {dd['whatif_s']:.2f} s "
          f"({[w['workload_class'] for w in dd['whatif']]}); a spawn pool "
          f"of 2 up with the scenario plane loaded in {dd['spawn_s']:.2f} "
          f"s, import per worker "
          f"{[round(s, 3) for s in dd['spawn_import_s']]} s, on the card "
          f"host's CPU [{card}]", flush=True)
    print(f"  phase 3a wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, routes


# -- phase 3k ----------------------------------------------------------------


@contextlib.contextmanager
def locks_into_lockdep():
    """Arm the ``lockdep`` boot param (reset its graph first) and feed it
    every ``ProfiledLock`` acquisition, under the lock's name, for the
    block; disarm and reset the graph after it.

    A ``ProfiledLock`` carries no lockdep hook in either package (only
    ``obs.lockdep.OrderedLock`` has one, and no lock of the runtime is
    one), so the param alone records none of the port's named locks. The
    bridge notes each acquisition before it blocks and each release after
    it, as ``OrderedLock`` does, and unwinds a failed try-acquire."""
    from pbs_tpu_torch.obs import lockdep
    from pbs_tpu_torch.obs.lockprof import ProfiledLock
    from pbs_tpu_torch.utils import params

    acquire, release = ProfiledLock.acquire, ProfiledLock.release

    def noted_acquire(self, blocking=True, timeout=-1):
        lockdep.note_acquire(self.stats.name)
        try:
            got = acquire(self, blocking, timeout)
        except BaseException:
            lockdep.note_release(self.stats.name)
            raise
        if not got:
            lockdep.note_release(self.stats.name)
        return got

    def noted_release(self):
        release(self)
        lockdep.note_release(self.stats.name)

    armed = params.get("lockdep")
    armed.set("on")
    lockdep.reset()
    ProfiledLock.acquire, ProfiledLock.release = noted_acquire, noted_release
    try:
        yield lockdep
    finally:
        ProfiledLock.acquire, ProfiledLock.release = acquire, release
        armed.reset()
        lockdep.reset()


def lockdep_run(tenants: dict, device, memory, tmp) -> dict:
    """Phase 3k (a): ``tenants`` ({name: (step fn, bytes)}) as jobs of one
    agent on 127.0.0.1 (a credit Partition over ``CudaBackend(device)``
    with a FeedbackPolicy and ``memory`` as its MemoryManager), created
    and run to their max_steps in one-round ``run`` calls through an
    RpcClient, each round's job list written to a Store, every named lock
    fed to lockdep; the graph exported to ``tmp``. Returns the graph, its
    path and the run's numbers."""
    from pbs_tpu_torch.dist import Agent, RpcClient
    from pbs_tpu_torch.runtime import Partition
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.store import Store
    from pbs_tpu_torch.telemetry import CudaBackend

    token = os.urandom(16).hex()
    agent = cli = None
    with locks_into_lockdep() as lockdep:
        try:
            part = Partition("k0.pool", source=CudaBackend(device=device),
                             scheduler="credit", memory=memory)
            FeedbackPolicy(part)  # held by the partition's timer wheel
            agent = Agent("k0", partition=part, auth_token=token,
                          device=device, workloads={
                              name: tenant_workload(fn, nbytes)
                              for name, (fn, nbytes) in tenants.items()})
            agent.start()
            cli = RpcClient(agent.address, auth_token=token, deadline_s=60.0)
            store = Store(os.path.join(tmp, "store.json"))
            for name in tenants:
                cli.call("create_job", job=name, workload=name, spec={
                             "max_steps": CHECK_STEPS[name],
                             "sched": {"weight": CHECK_WEIGHTS[name]}})
            t = time.monotonic()
            rounds, jobs = 0, []
            while rounds < CHECK_ROUND_LIMIT:
                cli.call("run", max_rounds=1, _timeout=60.0)
                rounds += 1
                jobs = cli.call("list_jobs")
                store.write("/k0/jobs", {j["job"]: j["state"] for j in jobs})
                if all(j["finished"] for j in jobs):
                    break
            wall = time.monotonic() - t
            graph = lockdep.export_graph()
            checked = lockdep.dump()["checked_edges"]
        finally:
            if cli is not None:
                cli.close()
            if agent is not None:
                agent.stop()
    check(all(j["finished"] and j["steps"] == CHECK_STEPS[j["job"]]
              for j in jobs) and len(jobs) == len(tenants),
          f"(a) {len(tenants)} jobs at their max_steps "
          f"({ {j['job']: j['steps'] for j in jobs} }) in {rounds} rounds")
    claims = memory.dump()
    check(all(claims["accounts"][n]["used"] == nbytes
              for n, (_, nbytes) in tenants.items()),
          f"(a) each tenant's working set claimed through the "
          f"MemoryManager ({ {n: b for n, (_, b) in tenants.items()} })")
    check(store.read("/k0/jobs") == {n: "finished" for n in tenants},
          "(a) the last round's job list read back from the Store")
    check(graph["violations"] == [],
          f"(a) no lock-order violation: {graph['violations']}")
    check(len(graph["edges"]) > 0,
          f"(a) the run nested named locks: {len(graph['edges'])} edges")
    path = os.path.join(tmp, "lockdep_graph.json")
    with open(path, "w") as f:
        json.dump(graph, f, indent=1)
    return dict(graph=graph, path=path, rounds=rounds, wall=wall,
                checked_edges=checked)


def run_checker(args: list, cwd: str) -> dict:
    """``pbst-torch check --format json ARGS`` in a child interpreter
    started in ``cwd`` (so findings name paths from there), its imports
    recorded by ``-X importtime``. Returns its exit code, its JSON, the
    top-level packages it imported and its wall seconds."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "pbs_tpu_torch.cli.pbst",
         "check", "--format", "json", *args],
        cwd=cwd, env=env, capture_output=True, text=True,
        timeout=CHECK_CHILD_TIMEOUT_S)
    wall = time.monotonic() - t
    tops = set()
    for ln in proc.stderr.splitlines():
        if ln.startswith("import time:") and ln.count("|") == 2:
            tops.add(ln.rsplit("|", 1)[1].strip().split(".")[0])
    try:
        out = json.loads(proc.stdout)
    except ValueError:
        errors = [ln for ln in proc.stderr.splitlines()
                  if not ln.startswith("import time:")]
        check(False, f"pbst-torch check printed no JSON (rc "
                     f"{proc.returncode}): {errors[-5:]}")
    return dict(rc=proc.returncode, out=out, tops=tops, wall=wall)


def port_fixture_tree(which: str, dst: str) -> str:
    """The checker's fixture tree ``tests/fixtures/analysis/<which>``
    copied into ``dst`` under the port's names: its ``pbs_tpu`` package
    becomes ``pbs_tpu_torch``, the C directory's sources go to
    ``pbs_tpu_torch/runtime/csrc``, and the word ``pbs_tpu`` in each
    ``.py`` file becomes ``pbs_tpu_torch``. Returns ``dst``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(repo, "tests", "fixtures", "analysis", which)
    check(os.path.isdir(src), f"the checker's fixture tree {src}")
    for root, _, files in os.walk(src):
        for name in files:
            parts = os.path.relpath(os.path.join(root, name), src).split(
                os.sep)
            if parts[0] == "pbs_tpu":
                parts[0] = "pbs_tpu_torch"
            else:  # the fixture's C directory
                parts = ["pbs_tpu_torch", "runtime", "csrc", *parts[1:]]
            with open(os.path.join(root, name), encoding="utf-8") as f:
                text = f.read()
            if name.endswith(".py"):
                text = re.sub(r"\bpbs_tpu\b", "pbs_tpu_torch", text)
            out = os.path.join(dst, *parts)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "w", encoding="utf-8") as f:
                f.write(text)
    return dst


def static_lock_edges(paths: list, root: str) -> dict:
    """The static lock-order edges the checker's lock pass records over
    ``paths``: {(holder, taken): (path from ``root``, line)}."""
    from pbs_tpu_torch.analysis import (CheckContext, SourceFile,
                                        iter_check_files)
    from pbs_tpu_torch.analysis.locks import LockDisciplinePass

    files = []
    for p in iter_check_files(paths):
        if p.endswith(".py"):
            with open(p, encoding="utf-8") as f:
                rel = os.path.relpath(os.path.abspath(p), root)
                files.append(SourceFile(p, f.read(),
                                        rel_path=rel.replace(os.sep, "/")))
    ctx = CheckContext(files)
    lock_pass = LockDisciplinePass()
    for src in files:
        lock_pass.run(src, ctx)
    return {edge: (path, pos[0]) for edge, (path, pos)
            in ctx.state.get("static_lock_edges", {}).items()}


def check_path_run(tenants: dict, device, memory, tmp) -> dict:
    """Phase 3k (a)-(c). (b) the checker over the port's tree with (a)'s
    graph; (c) one static lock edge the checker records (over the port's
    tree if it has one, else over the port-named clean fixture tree),
    checked with (a)'s graph alone, then with its reverse added. Every
    check raises ``Failed``. Returns the numbers the phase prints."""
    from pbs_tpu_torch.analysis import pass_ids

    repo = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(repo, "pbs_tpu_torch")
    out = dict(a=lockdep_run(tenants, device, memory, tmp))
    graph = out["a"]["graph"]

    # -- (b) ---------------------------------------------------------------
    b = run_checker(["--lockdep-graph", out["a"]["path"], pkg], cwd=repo)
    r = b["out"]
    check(b["rc"] == 0 and r["findings"] == [],
          f"(b) the port's tree is clean with the live graph (rc "
          f"{b['rc']}, {len(r['findings'])} findings)")
    check([s["check"] for s in r["suppressed"]] == list(CHECK_SUPPRESSED),
          f"(b) exactly the {len(CHECK_SUPPRESSED)} justified "
          f"suppressions: {[s['check'] for s in r['suppressed']]}")
    check(r["passes"] == pass_ids(),
          f"(b) every pass ran, in order ({len(r['passes'])})")
    check(not b["tops"] & {"torch", "jax", "jaxlib", "pbs_tpu"},
          f"(b) the checker imported no torch, JAX or pbs_tpu "
          f"({len(b['tops'])} top-level modules)")
    out["b"] = b

    # -- (c) ---------------------------------------------------------------
    tree_edges = static_lock_edges([pkg], repo)
    target, edges = pkg, tree_edges
    cwd = repo
    if not edges:
        cwd = port_fixture_tree("clean", os.path.join(tmp, "clean"))
        target = os.path.join(cwd, "pbs_tpu_torch")
        edges = static_lock_edges([target], cwd)
    check(len(edges) > 0, f"(c) a static lock edge to reverse "
                          f"({len(tree_edges)} in the port's tree)")
    (holder, taken), (where, line) = sorted(edges.items())[0]
    base = run_checker(["--lockdep-graph", out["a"]["path"], target], cwd)
    check(base["rc"] == 0 and base["out"]["findings"] == [],
          f"(c) {os.path.relpath(target, cwd)} clean with the live graph "
          f"alone (rc {base['rc']})")
    inverted = dict(graph, edges=sorted(graph["edges"] + [[taken, holder]]))
    inv_path = os.path.join(tmp, "lockdep_graph_inverted.json")
    with open(inv_path, "w") as f:
        json.dump(inverted, f, indent=1)
    inv = run_checker(["--lockdep-graph", inv_path, target], cwd)
    got = [(f["check"], f["path"], f["line"]) for f in inv["out"]["findings"]]
    check(inv["rc"] == 1 and got == [("lock-order", where, line)],
          f"(c) with {taken} -> {holder} added: exactly one lock-order "
          f"finding at the edge {holder} -> {taken} ({where}:{line}): "
          f"{got}, rc {inv['rc']}")
    out["c"] = dict(tree_edges=len(tree_edges), edge=(holder, taken),
                    where=f"{where}:{line}", base=base, inv=inv)
    return out


def check_path_lines(out: dict, card: str) -> None:
    a, b, c = out["a"], out["b"], out["c"]
    g = a["graph"]
    print(f"  (a) {a['rounds']} rounds in {a['wall']:.2f} s; lockdep "
          f"classes {g['classes']}; {len(g['edges'])} edges "
          f"{[tuple(e) for e in g['edges']]}; {a['checked_edges']} nested "
          f"acquisitions checked; violations {g['violations']}", flush=True)
    print(f"  (b) pbst-torch check: {b['out']['files_scanned']} files, "
          f"{len(b['out']['findings'])} findings, "
          f"{len(b['out']['suppressed'])} suppressed, "
          f"{b['wall']:.2f} s wall in a child process, on the card host's "
          f"CPU [{card}]", flush=True)
    print(f"  (c) {c['tree_edges']} static lock edges in the port's tree; "
          f"reversed {c['edge'][0]} -> {c['edge'][1]} ({c['where']}): "
          f"rc {c['base']['rc']} -> {c['inv']['rc']}, "
          f"{c['base']['wall']:.2f} / {c['inv']['wall']:.2f} s", flush=True)


def run_check_path(torch, gen, cfg, params, card):
    """Phase 3k on the card: phase 3's score (2.1) and mm (2.4) tenants
    under lockdep through one agent, then the checker with the live
    graph and the negative control. Returns (a)'s kernel launch counts
    and routes."""
    import tempfile

    from pbs_tpu_torch.runtime.memory import MemoryManager

    t_phase = time.monotonic()
    score_fn = scoring_tenant(torch, gen, cfg, params)
    mm_fn = mm_tenant(torch, gen)
    for fn in (score_fn, mm_fn):
        fn(None)  # warm outside the partition
    torch.cuda.synchronize()
    tenants = {
        # bf16 logits of the scored window; bf16 operands and fp32 product
        "score": (score_fn, SCORE_BATCH * SCORE_SEQ * cfg.vocab * 2),
        "mm": (mm_fn, 2 * MM_N * MM_N * 2 + MM_N * MM_N * 4),
    }
    memory = MemoryManager.for_device()
    wrappers = bwd_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3k_") as tmp:
        reset_counts(wrappers)
        out = check_path_run(tenants, "cuda", memory, tmp)
        launches, routes = control_launches(wrappers)
    check_path_lines(out, card)
    for k in KERNELS:
        n = launches[k]
        if k in ("flash_fwd", "instrumented_matmul"):
            check(n > 0 and routes[k] == {"wgmma": n, "simt": 0},
                  f"(a) {k}: {n} launches, every one on the tensor-core "
                  f"route ({routes[k]})")
        else:
            check(n == 0, f"(a) {k}: no launch (no backward on this path)")
    print(f"  (a) kernel launches {launches}, by route {routes}", flush=True)
    print(f"  phase 3k wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, routes


# -- phase 3f ----------------------------------------------------------------

#: The observer child of phase 3f(b): imports the port's command line and
#: what its ``oprofile`` loads (no torch; the native runtime loaded), says
#: "ready", runs ``pbst-torch oprofile`` on the partition's ledger until
#: the parent closes its stdin (a thread of its own then interrupts its
#: main thread: the command's own contract, a partial profile is still a
#: profile; ``--seconds`` is only its deadline), then ``pbst-torch mon``
#: on the meta sidecar, and prints the exit codes and the torch, JAX or
#: ``pbs_tpu`` modules it imported. The parent signals no process.
OBSERVER_CHILD = r"""
import _thread, json, sys, threading
sys.path.insert(0, sys.argv[1])
from pbs_tpu_torch.cli.pbst import main
import pbs_tpu_torch.obs.mon, pbs_tpu_torch.obs.oprofile
from pbs_tpu_torch.runtime import native
native.load()
native.fastcall()
ledger, name, seconds, period, iters = sys.argv[2:7]


def stop_on_eof():
    sys.stdin.read()
    _thread.interrupt_main()


threading.Thread(target=stop_on_eof, daemon=True).start()
print("ready", flush=True)
rc_op = main(["oprofile", "--ledger", ledger, "--name", name,
              "--seconds", seconds, "--period", period])
print("--- mon", flush=True)
rc_mon = main(["mon", ledger + ".meta.json", "--iterations", iters,
               "--interval", "0.05", "--window", "1.0", "--windows", "10"])
bad = sorted({m.split(".")[0] for m in sys.modules}
             & {"torch", "jax", "jaxlib", "pbs_tpu"})
print(json.dumps({"rc_oprofile": rc_op, "rc_mon": rc_mon,
                  "imported": bad}), flush=True)
"""


def foreign_tenants(torch, gen, cfg, params, device, score_shape: tuple,
                    mm_n: int, ew_numel: int) -> dict:
    """Phase 3f's foreign tenants: {name: (callable, args)}, none
    following the Job protocol. ``fscore``: phase 3's scoring forward
    through the flash kernel, a plain function of its tokens; ``fmm``:
    OBSERVER_MM_CHAIN chained bf16 ``torch.mm`` at ``mm_n``^2, the 1/sqrt(n)
    scale carried in the right operand (a separate scaling pass would be
    an elementwise kernel inside the compute-bound tenant); ``few``:
    OBSERVER_EW_PASSES tanh-scale-shift passes over ``ew_numel`` fp32.
    ``score_shape`` is the scored window, (SCORE_BATCH, SCORE_SEQ) on the
    card."""
    from pbs_tpu_torch.models import forward

    tokens = torch.randint(0, cfg.vocab, score_shape, device=device,
                           generator=gen)
    score_cfg = dataclasses.replace(cfg, attn_impl="pallas")

    @torch.no_grad()
    def fscore(tok):
        return forward(score_cfg, params, tok)[:, -1].argmax(dim=-1)

    a = torch.randn(mm_n, mm_n, device=device, generator=gen).bfloat16()
    w = (torch.randn(mm_n, mm_n, device=device, generator=gen)
         / math.sqrt(mm_n)).bfloat16()

    def fmm(x, y):
        for _ in range(OBSERVER_MM_CHAIN):
            x = torch.mm(x, y)
        return x

    v = torch.randn(ew_numel, device=device, generator=gen)

    def few(x, scale):
        for _ in range(OBSERVER_EW_PASSES):
            x = torch.tanh(x) * scale + 0.1
        return x

    return {"fscore": (fscore, (tokens,)), "fmm": (fmm, (a, w)),
            "few": (few, (v, 0.5))}


def pbst_child(args: list, cwd: str | None = None,
               timeout: float = CHECK_CHILD_TIMEOUT_S,
               module: str = "pbs_tpu_torch.cli.pbst") -> dict:
    """``pbst-torch ARGS`` (or ``python -m MODULE ARGS``) in a child
    interpreter: its exit code, stdout, stderr and wall seconds."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=cwd or repo, env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=timeout)
    return dict(rc=proc.returncode, out=proc.stdout, err=proc.stderr,
                wall=time.monotonic() - t)


def oprofile_rows(text: str) -> dict:
    """The rows of ``pbst-torch oprofile``'s table: job -> numbers."""
    rows = {}
    for ln in text.splitlines():
        parts = ln.split()
        if len(parts) == 7 and parts[0] != "job":
            rows[parts[0]] = dict(
                samples=int(parts[1]), lost=int(parts[2]),
                device_ms=float(parts[3]), stall_pct=float(parts[4]),
                coll_ms=float(parts[5]), last_step=int(parts[6]))
    return rows


def mon_rows(text: str) -> dict:
    """The rows of ``pbst-torch mon``'s last frame: job -> numbers."""
    frame = text.rsplit("pbst mon", 1)[-1]
    rows = {}
    for ln in frame.splitlines()[2:]:
        parts = ln.split()
        if len(parts) == 8:
            rows[parts[1]] = dict(slot=int(parts[0]), ctx=parts[2],
                                  cpu_pct=float(parts[4]),
                                  gotten_ms=float(parts[5]),
                                  execs=int(parts[6]), wakes=int(parts[7]))
    return rows


def start_observer(ledger: str, name: str):
    """Phase 3f(b)'s child, started and attached: returns the process
    once it said "ready" (its ``oprofile`` primes its baselines a few
    milliseconds after)."""
    import selectors

    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", OBSERVER_CHILD, repo, ledger, name,
         str(OBSERVER_DEADLINE_S), str(OBSERVER_PERIOD_MS),
         str(OBSERVER_MON_ITERATIONS)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    ready = sel.select(timeout=60) and proc.stdout.readline().strip()
    sel.close()
    if ready != "ready":
        err = ""
        try:  # ends on its own: it found no ledger, or stdin closed
            err = proc.communicate(input="", timeout=60)[1]
        except subprocess.TimeoutExpired:
            pass  # its own deadline ends it
        check(False, f"(b) the observer child attached ({ready!r}, rc "
                     f"{proc.returncode}): {err.strip()[-400:]}")
    time.sleep(OBSERVER_PRIME_S)
    return proc


def stop_observer(proc) -> dict:
    """Closing the child's stdin ends its ``oprofile`` (after at least
    two sampling periods past the run's end), then its ``mon`` runs;
    returns the parsed tables and the child's final line."""
    time.sleep(3 * OBSERVER_PERIOD_MS / 1e3)
    try:
        out, err = proc.communicate(input="",
                                    timeout=OBSERVER_DEADLINE_S + 60)
    except subprocess.TimeoutExpired:
        check(False, "(b) the observer child ended")
    op_text, _, mon_text = out.partition("--- mon")
    lines = mon_text.strip().splitlines()
    try:
        final = json.loads(lines[-1]) if lines else {}
    except ValueError:
        final = {}
    return dict(rc=proc.returncode, err=err, oprofile=oprofile_rows(op_text),
                mon=mon_rows("\n".join(lines[:-1])), final=final,
                oprofile_text=op_text, mon_text=mon_text)


def observer_run(tenants: dict, device, tmp, steps: dict,
                 flops_fmm: int) -> dict:
    """Phase 3f (a)-(c), each check raising ``Failed``.

    (a) the tenants of :func:`foreign_tenants` adopted through
    ``Job.foreign`` (``profile_every=1``, a first slice of
    OBSERVER_TSLICE_US) into one credit Partition on
    ``CudaBackend(device, profile_every=0)`` with a file-backed ledger and
    trace rings and a FeedbackPolicy ticking every round, run until each
    retires ``steps[name]``, with the ``lock_profile`` param on and every
    named lock fed to lockdep; (b) while it runs, a child process that
    imports no torch profiles the ledger passively (``oprofile``), then
    digests the rings (``mon``); (c) the phase's obs dump through the
    ``perfc``, ``lockprof``, ``params`` and ``lockdep --dump-graph``
    commands, the graph into ``check --lockdep-graph`` over the port-named
    clean fixture tree, then a reversed fixture edge taken live, dumped and
    checked. Returns the numbers the phase prints."""
    from pbs_tpu_torch.obs.dumpfile import write_obs_dump
    from pbs_tpu_torch.obs.lockdep import OrderedLock
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import Counter, CudaBackend
    from pbs_tpu_torch.telemetry.source import CountedCost
    from pbs_tpu_torch.utils import params

    ledger = os.path.join(tmp, "observed.ledger")
    out: dict = {}
    profiling = params.get("lock_profile")
    profiling.set("on")
    try:
        with locks_into_lockdep() as lockdep:
            be = CudaBackend(device=device, profile_every=0)
            part = Partition("observed", source=be, scheduler="credit",
                             ledger_path=ledger,
                             trace_dir=os.path.join(tmp, "traces"))
            FeedbackPolicy(part, tick_ns=1)  # held by the timer wheel
            jobs = {
                name: part.add_job(Job.foreign(
                    name, fn, *args, profile_every=1,
                    max_steps=steps[name],
                    params=SchedParams(tslice_us=OBSERVER_TSLICE_US)))
                for name, (fn, args) in tenants.items()}
            child = start_observer(ledger, OBSERVER_NAME)
            try:
                before = {n: int(j.contexts[0].counters[
                    Counter.DEVICE_TIME_NS]) for n, j in jobs.items()}
                t = time.monotonic()
                quanta = part.run()
                wall = time.monotonic() - t
            finally:
                seen = stop_observer(child)
            dump1 = os.path.join(tmp, "obs.json")
            write_obs_dump(dump1)
            # (c)'s negative control, by the reference's route: the clean
            # fixture's static edge taken live in reverse, then dumped.
            fixture = port_fixture_tree("clean", os.path.join(tmp, "clean"))
            target = os.path.join(fixture, "pbs_tpu_torch")
            edges = static_lock_edges([target], fixture)
            check(len(edges) > 0, "(c) the clean fixture's static lock edge")
            (holder, taken), (where, line) = sorted(edges.items())[0]
            with OrderedLock(taken):
                with OrderedLock(holder):
                    pass
            dump2 = os.path.join(tmp, "obs_reversed.json")
            write_obs_dump(dump2)
            violations = lockdep.violations()
    finally:
        profiling.reset()

    # -- (a) ---------------------------------------------------------------
    ctr = {n: j.contexts[0].counters for n, j in jobs.items()}
    dev = {n: int(c[Counter.DEVICE_TIME_NS]) for n, c in ctr.items()}
    check(all(j.steps_retired() == steps[n] for n, j in jobs.items()),
          f"(a) every tenant retired its steps "
          f"({ {n: j.steps_retired() for n, j in jobs.items()} } == {steps})"
          f" in {quanta} quanta, {wall:.2f} s")
    check(all(isinstance(j.compiled, CountedCost) for j in jobs.values()),
          f"(a) job.compiled harvested for all three: "
          f"{ {n: j.compiled for n, j in jobs.items()} } (harvest errors "
          f"{be.harvest_errors})")
    per_step = int(ctr["fmm"][Counter.DEVICE_FLOPS]) / steps["fmm"]
    check(abs(per_step - flops_fmm) <= 0.01 * flops_fmm,
          f"(a) fmm's DEVICE_FLOPS per step {per_step:.6g} == "
          f"{OBSERVER_MM_CHAIN} x 2 x n^3 = {flops_fmm:.6g} within 1%")
    stall = {n: be.measured(n).stall_frac if be.measured(n) else None
             for n in jobs}
    prof = be.profiler
    check(stall["few"] is not None and stall["fmm"] is not None
          and stall["few"] >= stall["fmm"] + 0.2,
          f"(a) few's measured stall fraction {stall['few']} exceeds "
          f"fmm's {stall['fmm']} by at least 0.2 (profiler: "
          f"{getattr(prof, 'samples', None)} samples, "
          f"{getattr(prof, 'failures', None)} failures, last error "
          f"{getattr(prof, 'last_error', None)}; samples a tenant "
          f"{ {n: c[0] for n, c in be.profile_cost.items()} })")
    slices = {n: j.params.tslice_us for n, j in jobs.items()}
    check(slices["few"] > OBSERVER_TSLICE_US > slices["fmm"],
          f"(a) the feedback policy grew few's quantum and shrank fmm's "
          f"from {OBSERVER_TSLICE_US} us: {slices}")
    compile_ms = {n: int(c[Counter.COMPILE_TIME_NS]) / 1e6
                  for n, c in ctr.items()}
    check(all(v > 0 for v in compile_ms.values()),
          f"(a) each counted invocation landed in its tenant's "
          f"COMPILE_TIME_NS ({compile_ms} ms)")
    check(violations == [], f"(a) no lock-order violation: {violations}")
    lost, launched = (getattr(prof, "records_lost", 0),
                      getattr(prof, "launches", 0))
    check(lost <= OBSERVER_LOST_SHARE * launched,
          f"(a) the profiled quanta's launches left without a device record: "
          f"{lost} of {launched}, at most {OBSERVER_LOST_SHARE:.0%} (the "
          f"session pads absorbed {getattr(prof, 'pad_lost', 0)} more over "
          f"{getattr(prof, 'samples', 0)} samples)")
    out["a"] = dict(quanta=quanta, wall=wall, steps=steps, slices=slices,
                    stall=stall, compile_ms=compile_ms, dev_ms={
                        n: v / 1e6 for n, v in dev.items()},
                    flops_per_step={n: int(c[Counter.DEVICE_FLOPS])
                                    / steps[n] for n, c in ctr.items()},
                    harvest={n: j.compiled for n, j in jobs.items()},
                    profile_cost=dict(be.profile_cost),
                    pad_lost=getattr(prof, "pad_lost", 0), lost=lost,
                    launched=launched)

    # -- (b) ---------------------------------------------------------------
    check(seen["rc"] == 0 and seen["final"].get("rc_oprofile") == 0
          and seen["final"].get("rc_mon") == 0,
          f"(b) the observer child's oprofile and mon exited 0 "
          f"({seen['final']}, rc {seen['rc']}): {seen['err'].strip()[-300:]}")
    check(seen["final"].get("imported") == [],
          f"(b) the observer child imported no torch, JAX or pbs_tpu "
          f"({seen['final'].get('imported')})")
    rows = seen["oprofile"]
    names = {f"{OBSERVER_NAME}/{n}" for n in jobs}
    check(set(rows) == names, f"(b) oprofile has a row per tenant: "
                              f"{sorted(rows)}")
    check(all(r["lost"] == 0 for r in rows.values()),
          f"(b) no sample lost: { {k: r['lost'] for k, r in rows.items()} }")
    window = {n: (dev[n] - before[n]) / 1e6 for n in jobs}
    got = {n: rows[f"{OBSERVER_NAME}/{n}"]["device_ms"] for n in jobs}
    tot_w, tot_g = sum(window.values()), sum(got.values())
    check(abs(tot_g - tot_w) <= 0.1 * tot_w and all(
              abs(got[n] - window[n]) <= 0.1 * window[n] for n in jobs),
          f"(b) oprofile's device_ms {got} (total {tot_g:.3f}) agree with "
          f"the partition's DEVICE_TIME_NS over the window {window} (total "
          f"{tot_w:.3f}) within 10%")
    mon = seen["mon"]
    check(set(mon) == set(jobs) and all(mon[n]["execs"] > 0 for n in jobs),
          f"(b) mon's rows name the three jobs with nonzero execs: "
          f"{ {n: r['execs'] for n, r in mon.items()} }")
    out["b"] = dict(oprofile=rows, window=window, mon=mon)

    # -- (c) ---------------------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    argvs = {"perfc": ["perfc", dump1], "lockprof": ["lockprof", dump1],
             "params": ["params", "--file", dump1],
             "graph": ["lockdep", dump1, "--dump-graph"],
             "graph_reversed": ["lockdep", dump2, "--dump-graph"]}
    with ThreadPoolExecutor(len(argvs)) as pool:
        cmds = dict(zip(argvs, pool.map(pbst_child, argvs.values())))
    check(all(c["rc"] == 0 for c in cmds.values()),
          f"(c) perfc, lockprof, params and lockdep --dump-graph on the "
          f"dumps exited 0 ({ {k: c['rc'] for k, c in cmds.items()} })")
    locks = [ln.split() for ln in cmds["lockprof"]["out"].splitlines()[1:]]
    check(any(int(r[1]) > 0 for r in locks),
          f"(c) lockprof shows the run's profiled locks "
          f"({[r[:2] for r in locks]})")
    check("lock_profile=true" in cmds["params"]["out"]
          and "lockdep=true" in cmds["params"]["out"],
          "(c) params shows lock_profile and lockdep on")
    with open(dump1) as f:
        dumped = json.load(f)
    listed = [ln.split()[0] for ln in cmds["perfc"]["out"].splitlines()]
    check(listed == list(dumped["perfc"]),
          f"(c) perfc lists the dump's {len(listed)} counters")
    graphs = {}
    for key in ("graph", "graph_reversed"):
        graphs[key] = os.path.join(tmp, f"{key}.json")
        with open(graphs[key], "w") as f:
            f.write(cmds[key]["out"])
    g1 = json.loads(cmds["graph"]["out"])
    g2 = json.loads(cmds["graph_reversed"]["out"])
    check(g1["violations"] == [] and [taken, holder] in g2["edges"]
          and [taken, holder] not in g1["edges"],
          f"(c) the dumped graphs: {len(g1['edges'])} live edges, no "
          f"violation; the reversed dump adds {taken} -> {holder}")
    base = run_checker(["--lockdep-graph", graphs["graph"], target],
                       fixture)
    check(base["rc"] == 0 and base["out"]["findings"] == [],
          f"(c) the clean fixture with the dumped live graph: rc "
          f"{base['rc']}, {len(base['out']['findings'])} findings "
          f"(3k (c)'s base verdict)")
    inv = run_checker(["--lockdep-graph", graphs["graph_reversed"],
                       target], fixture)
    found = [(f["check"], f["path"], f["line"])
             for f in inv["out"]["findings"]]
    check(inv["rc"] == 1 and found == [("lock-order", where, line)],
          f"(c) with the reversed edge dumped: exactly one lock-order "
          f"finding at {holder} -> {taken} ({where}:{line}): {found}, rc "
          f"{inv['rc']} (3k (c)'s verdict)")
    out["c"] = dict(graph=g1, edge=(holder, taken), where=f"{where}:{line}",
                    base=base, inv=inv, walls={
                        k: c["wall"] for k, c in cmds.items()},
                    counters=len(cmds["perfc"]["out"].splitlines()),
                    locks=[r[:2] for r in locks])
    return out


def observer_lines(out: dict, card: str) -> None:
    a, b, c = out["a"], out["b"], out["c"]
    print(f"  (a) {a['quanta']} quanta in {a['wall']:.2f} s; device "
          f"records lost by the profiler: {a['pad_lost']} on the sessions' "
          f"pads, {a['lost']} of the quanta's {a['launched']} launches "
          f"[{card}]")
    print(f"  {'tenant':<7} {'steps':>5} {'device_ms':>10} {'stall':>6} "
          f"{'slice_us':>13} {'flops/step':>11} {'bytes (harvest)':>16} "
          f"{'harvest_ms':>10} {'samples':>7} {'prof_ms':>8}")
    for n in a["steps"]:
        cost = a["profile_cost"].get(n, [0, 0, 0])
        st = a["stall"][n]
        print(f"  {n:<7} {a['steps'][n]:>5} {a['dev_ms'][n]:>10.2f} "
              f"{(f'{st:.3f}' if st is not None else '-'):>6} "
              f"{OBSERVER_TSLICE_US:>5} -> {a['slices'][n]:>5} "
              f"{a['flops_per_step'][n]:>11.4g} "
              f"{a['harvest'][n].nbytes:>16} {a['compile_ms'][n]:>10.1f} "
              f"{cost[0]:>7} {cost[2] / 1e6:>8.1f}", flush=True)
    prof = {k: (r["samples"], r["device_ms"], r["lost"])
            for k, r in b["oprofile"].items()}
    window = {k: round(v, 3) for k, v in b["window"].items()}
    mon = {k: (r["execs"], r["gotten_ms"]) for k, r in b["mon"].items()}
    print(f"  (b) oprofile (samples, device_ms, lost): {prof} against the "
          f"partition's {window} ms; mon (execs, gotten_ms): {mon}",
          flush=True)
    print(f"  (c) dump: {c['counters']} perfc counters, locks {c['locks']}, "
          f"live graph classes {c['graph']['classes']} edges "
          f"{c['graph']['edges']}; reversed {c['edge'][1]} -> "
          f"{c['edge'][0]} ({c['where']}): rc {c['base']['rc']} -> "
          f"{c['inv']['rc']}, {c['base']['wall']:.2f} / "
          f"{c['inv']['wall']:.2f} s; command walls "
          f"{ {k: round(v, 2) for k, v in c['walls'].items()} } s",
          flush=True)


def host_costs(tmp, card: str, baseline_out: str | None = None) -> dict:
    """Phase 3f(d): ``pbst-torch selftest`` (every canary on every tier),
    ``perf --json`` in python and native mode at full and quick op counts
    (two lanes of child processes: the full python matrix beside the other
    three), the four maps saved as a stamped baseline, and ``perf --check
    --quick`` of both modes against it."""
    from concurrent.futures import ThreadPoolExecutor

    from pbs_tpu_torch.perf import load_baseline, save_baseline

    t = time.monotonic()
    st = pbst_child(["selftest"])
    rows = [ln.split() for ln in st["out"].splitlines() if ln.strip()]
    check(st["rc"] == 0 and rows and all(r[-1] == "ok" for r in rows),
          f"(d) selftest: every canary passes on every tier "
          f"({len(rows)} rows, rc {st['rc']})")

    def lane(argvs):
        return [pbst_child(["perf", "--json", *a]) for a in argvs]

    with ThreadPoolExecutor(2) as pool:
        first = pool.submit(lane, [[]])
        rest = pool.submit(lane, [["--quick"], ["--native"],
                                  ["--native", "--quick"]])
        runs = first.result() + rest.result()
    check(all(r["rc"] == 0 for r in runs),
          f"(d) perf --json in four modes exited 0 "
          f"({[r['rc'] for r in runs]}): {[r['err'][-200:] for r in runs]}")
    full, quick, nfull, nquick = (json.loads(r["out"]) for r in runs)
    check(nfull["native_tier"] in ("fastcall", "ctypes"),
          f"(d) the native matrices ran on a native tier "
          f"({nfull['native_tier']})")
    path = os.path.join(tmp, "baseline.json")
    save_baseline(full, path, quick_results=quick)
    save_baseline(nfull, path, quick_results=nquick)
    stamp = load_baseline(path)["host"]
    if baseline_out:
        os.makedirs(os.path.dirname(os.path.abspath(baseline_out)),
                    exist_ok=True)
        with open(path) as src, open(baseline_out, "w") as dst:
            dst.write(src.read())
    with ThreadPoolExecutor(2) as pool:
        gates = list(pool.map(lambda a: pbst_child(
            ["perf", "--check", "--quick", "--baseline", path, *a]),
            [[], ["--native"]]))
    check(all(g["rc"] == 0 for g in gates),
          f"(d) perf --check --quick in both modes against the maps just "
          f"recorded exited 0 ({[g['rc'] for g in gates]}): "
          f"{[g['err'][-300:] for g in gates]}")
    return dict(selftest=rows, maps=dict(benches=full, quick=quick,
                                         native=nfull, native_quick=nquick),
                stamp=stamp, wall=time.monotonic() - t,
                walls=[r["wall"] for r in runs] + [g["wall"] for g in gates])


#: Phase 3n(d)'s calls beside the perf benches measuring the same path.
BENCH_VS_TIER = {"trace.emit": "ring.emit",
                 "ledger.snapshot_many": "ledger.snapshot_many",
                 "hist.record_many": "hist.record_many"}


def host_cost_lines(d: dict, card: str, native_costs: dict) -> None:
    print(f"  (d) selftest, ns/op per tier [{card}; CPU {d['stamp']['cpu']}]:")
    for r in d["selftest"]:
        print(f"    {' '.join(r)}")
    m = d["maps"]
    tiers = list(native_costs)
    print(f"  (d) perf ns/op, python / native (full, quick), beside 3n(d)'s "
          f"calls per tier ({', '.join(tiers) or '3n not run'}); torch "
          f"{d['stamp']['torch']}, native tier {d['stamp']['native_tier']}:")
    for name, r in m["benches"]["benches"].items():
        nat = m["native"]["benches"].get(name)
        nq = m["native_quick"]["benches"].get(name)
        line = (f"    {name:<22} {r['ns_per_op']:>12} "
                f"{m['quick']['benches'][name]['ns_per_op']:>12} "
                f"{(nat['ns_per_op'] if nat else '-'):>10} "
                f"{(nq['ns_per_op'] if nq else '-'):>10}")
        call = BENCH_VS_TIER.get(name)
        if call and tiers:
            line += (f"   3n {call}: " + " / ".join(
                f"{native_costs[t][call]:.1f}" for t in tiers))
        print(line)
    print(f"  (d) {d['wall']:.1f} s (children "
          f"{[round(w, 1) for w in d['walls']]} s)", flush=True)


def run_observer_path(torch, gen, cfg, params, card, native_costs: dict,
                      baseline_out: str | None = None):
    """Phase 3f on the card: the foreign tenants and their observers, the
    obs dump's route into the checker, the host's costs (printed beside
    ``native_costs``, 3n(d)'s per tier, when given). Returns (a)'s kernel
    launch counts and routes."""
    import tempfile

    t_phase = time.monotonic()
    tenants = foreign_tenants(torch, gen, cfg, params, "cuda",
                              (SCORE_BATCH, SCORE_SEQ), MM_N,
                              OBSERVER_EW_NUMEL)
    wrappers = bwd_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3f_") as tmp:
        reset_counts(wrappers)
        out = observer_run(tenants, "cuda", tmp, OBSERVER_STEPS,
                           OBSERVER_MM_CHAIN * 2 * MM_N ** 3)
        launches, routes = control_launches(wrappers)
        observer_lines(out, card)
        want = cfg.n_layers * (OBSERVER_STEPS["fscore"] + 1)
        for k in KERNELS:
            n = launches[k]
            if k == "flash_fwd":
                check(n == want and routes[k] == {"wgmma": n, "simt": 0},
                      f"(a) flash_fwd: {n} launches == {cfg.n_layers} x "
                      f"({OBSERVER_STEPS['fscore']} fscore steps + the "
                      f"counted invocation), all \"wgmma\" ({routes[k]})")
            else:
                check(n == 0, f"(a) {k}: no launch (fmm and few are "
                              f"torch.mm and elementwise, no backward)")
        print(f"  (a) kernel launches {launches}, by route {routes}",
              flush=True)
        costs = host_costs(tmp, card, baseline_out)
    host_cost_lines(costs, card, native_costs)
    print(f"  phase 3f wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, routes


# -- phase 3x ----------------------------------------------------------------


def parallel_config(torch, family: str, fields: dict):
    """The config of a phase-3x run: ``fields`` with ``dtype`` named."""
    from pbs_tpu_torch.models import MoEConfig, TransformerConfig

    fields = dict(fields, dtype=getattr(torch, fields["dtype"]))
    return (MoEConfig if family == "moe" else TransformerConfig)(**fields)


def parallel_tokens(torch, seed: int, batch: int, seq: int, vocab: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (batch, seq)))


def parallel_schedules(dense: dict, moe: dict, depth: int) -> list:
    """Phase 3x (b)'s schedules: the sp2 flash ring at ``dense``'s full
    depth, the rest at ``depth`` layers; "base" names the single-process
    run of (a) each is held to."""
    shallow = dict(dense, n_layers=depth)
    return [
        dict(name="sp2 ring, flash blocks", family="dense", axes={"sp": 2},
             cfg=dict(dense, attn_impl="ring", ring_block="flash"),
             base="dense"),
        dict(name="sp2 Ulysses, flash", family="dense", axes={"sp": 2},
             cfg=dict(shallow, attn_impl="ulysses", ring_block="flash"),
             base="shallow"),
        dict(name="tp2, sequence parallel", family="dense", axes={"tp": 2},
             cfg=shallow, base="shallow"),
        dict(name="pp2, 2 microbatches", family="pipe", axes={"pp": 2},
             cfg=shallow, base="shallow"),
        dict(name="MoE ep2", family="moe", axes={"ep": 2},
             cfg=dict(moe, n_layers=depth), base="moe"),
    ]


def grad_norms(tree, mesh=None, specs=None, prefix="") -> dict:
    """{leaf name: [norm]}, a norm per layer for the leaves stacked over
    layers. With ``mesh`` and ``specs`` the tree is this rank's block of
    the summed gradients: the squares are summed (and the layer rows
    gathered) over the axes that shard each leaf, so every rank returns
    the global tree's norms."""
    from pbs_tpu_torch.parallel import comm
    from pbs_tpu_torch.parallel.sharding import _mesh_spec

    out = {}
    for key in sorted(tree):
        name, val = prefix + key, tree[key]
        spec = None if specs is None else specs[key]
        if isinstance(val, dict):
            out.update(grad_norms(val, mesh, spec, name + "/"))
            continue
        g = val.detach().float()
        layered = name.startswith("layers/")
        sq = (g * g).flatten(1).sum(1) if layered else (g * g).sum()[None]
        for dim, entry in enumerate(() if mesh is None
                                    else _mesh_spec(mesh, spec)):
            for axis in entry if isinstance(entry, tuple) else (entry,):
                if axis is None or mesh.size(axis) == 1:
                    continue
                if layered and dim == 0:
                    sq = comm._all_gather(sq, mesh.group(axis), 0)
                else:
                    comm.all_reduce_(sq, mesh.group(axis))
        out[name] = sq.sqrt().tolist()
    return out


def grad_norm_diff(want: dict, got: dict) -> tuple[float, str]:
    """The largest relative difference of two :func:`grad_norms` and
    where it is."""
    worst, where = 0.0, ""
    for name, w in want.items():
        g = got[name]
        if len(g) != len(w):
            return math.inf, f"{name}: {len(g)} norms, not {len(w)}"
        for i, (a, b) in enumerate(zip(w, g)):
            d = abs(b - a) / max(abs(a), 1e-12)
            if not d <= worst:  # a NaN counts as the worst
                worst, where = d, f"{name}[{i}]"
    return worst, where


def parallel_baseline(torch, family: str, fields: dict, device: str,
                      seed: int, batch: int, seq: int, steps: int,
                      lr: float) -> list:
    """Phase 3x (a): ``steps`` AdamW steps in this process from the
    seed's weights on the seed's tokens; (the losses, ms per step on the
    host clock, closed by the loss's read, the first step's gradients'
    :func:`grad_norms`)."""
    import gc

    from pbs_tpu_torch.models import (init_moe_params, init_params,
                                      make_moe_train_step, make_train_step,
                                      moe_loss)
    from pbs_tpu_torch.models.transformer import (loss_and_grads,
                                                  value_and_grad)

    cfg = parallel_config(torch, family, fields)
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = parallel_tokens(torch, seed, batch, seq, cfg.vocab).to(device)
    if family == "moe":
        params = init_moe_params(cfg, gen, device=device)
        init_opt, step = make_moe_train_step(cfg, learning_rate=lr)
        grads = value_and_grad(lambda p: moe_loss(cfg, p, tokens), params)[1]
    else:
        params = init_params(cfg, gen, device=device)
        init_opt, step = make_train_step(cfg, learning_rate=lr)
        grads = loss_and_grads(cfg, params, tokens)[1]
    norms = grad_norms(grads)  # the first step's gradients
    del grads
    state = (params, init_opt(params), 0)
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, tokens)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    del state, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return losses, ms, norms


def staged_exchanges(device: str, seed: int) -> dict:
    """Phase 3x on one rank process: each exchange of
    :mod:`pbs_tpu_torch.parallel.comm`, forward and backward, on this
    rank's tensor on ``device`` (on the card over gloo: staged through
    pinned host memory) and on its host copy (gloo's own transport).
    Returns {exchange: max |difference|} of the outputs and gradients."""
    import torch
    import torch.distributed as dist

    from pbs_tpu_torch.parallel import comm

    group = dist.group.WORLD
    n, me = comm.group_size(group), comm.group_index(group)
    ring = [(i, (i + 1) % n) for i in range(n)]
    ops = {
        "psum": lambda t: comm.psum(t, group),
        "all_gather": lambda t: comm.all_gather(t, group, 1),
        "reduce_scatter": lambda t: comm.reduce_scatter(t, group, 1),
        "all_to_all": lambda t: comm.all_to_all(t, group, 1, 0),
        "ppermute": lambda t: comm.ppermute(t, group, ring),
    }
    x = torch.randn(4, 6 * n, 8,
                    generator=torch.Generator().manual_seed(seed + me))
    out = {}
    for name, op in ops.items():
        got = []
        for dev in (device, "cpu"):
            t = x.to(dev, copy=True).requires_grad_()
            y = op(t)
            w = torch.randn(y.shape, generator=torch.Generator()
                            .manual_seed(seed + n + me)).to(dev)
            (y * w).sum().backward()
            got.append((y.detach().cpu(), t.grad.cpu()))
        out[name] = max(float((a - b).abs().max()) for a, b in zip(*got))
    # a pipeline hand-off, member 0 to member 1, and its cotangent back
    got = []
    for dev in (device, "cpu"):
        t = x.to(dev, copy=True).requires_grad_()
        if me == 0:
            comm.send(t, group, 1, tag=3).backward()
            got.append(t.grad.cpu())
        elif me == 1:
            anchor = torch.zeros((), device=dev, requires_grad=True)
            y = comm.recv(anchor, x.shape, x.dtype, group, 0, tag=3)
            (y * 2.0).sum().backward()
            got.append(y.detach().cpu())
    if len(got) == 2:
        out["send/recv"] = float((got[0] - got[1]).abs().max())
    comm.release()
    return out


def parallel_rank_run(sched: dict, device: str, seed: int, batch: int,
                      seq: int, steps: int, lr: float) -> dict:
    """Phase 3x (b) on one rank process: the schedule's trainer from the
    seed's weights (every rank draws the full tree, then keeps its
    shards), ``steps`` steps on this rank's block of the seed's tokens.
    Returns the global losses, ms per step (host clock, closed by the
    loss's read), launches of 2.1-2.3 by route, each step's exchanges
    (``comm.stats``: count, bytes staged through the host, host
    seconds), the peak device memory and the first step's global
    :func:`grad_norms`; then frees the schedule's state and its pinned
    staging buffers."""
    import torch
    import torch.distributed as dist

    from pbs_tpu_torch import parallel
    from pbs_tpu_torch.models import init_moe_params, init_params
    from pbs_tpu_torch.parallel import comm, pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    family = sched["family"]
    cfg = parallel_config(torch, "moe" if family == "moe" else "dense",
                          sched["cfg"])
    mesh = parallel.make_mesh(sched["axes"], device=device)
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    init = init_moe_params if family == "moe" else init_params
    params = init(cfg, gen, device=dev)
    if family == "pipe":
        state, step = pipeline.make_pipelined_train(
            cfg, mesh, n_micro=2, learning_rate=lr, params=params)
        sharding = pipeline.pipeline_batch_sharding(mesh)
    elif family == "moe":
        state, step = parallel.make_sharded_moe_train(cfg, mesh, lr,
                                                      params=params)
        sharding = parallel.moe_batch_sharding(mesh)
    else:
        state, step = parallel.make_sharded_train(cfg, mesh, lr,
                                                  params=params)
        sharding = parallel.batch_sharding(mesh)
    del params
    trainer, norms = step.__self__, {}
    summed = trainer.loss_and_grads

    def first_grads(p, t):  # the step's own gradients, norms taken once
        metrics, grads = summed(p, t)
        if not norms:
            norms.update(grad_norms(grads, trainer.mesh, trainer.specs))
        return metrics, grads

    trainer.loss_and_grads = first_grads
    block = sharding.shard(parallel_tokens(torch, seed, batch, seq,
                                           cfg.vocab))
    wrappers = bwd_counts()[:3]
    reset_counts(wrappers)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, ms, exchanges = [], [], []
    for _ in range(steps):
        comm.reset_stats()
        t0 = time.perf_counter()
        state, m = step(state, block)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        exchanges.append(comm.stats())
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "device": str(dev), "losses": losses, "ms": ms,
           "launches": {k: dict(w.launches_by_route)
                        for k, w in zip(KERNELS, wrappers)},
           "exchanges": exchanges,
           "block": tuple(block.shape),
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else 0),
           "grad_norms": norms}
    if dist.get_backend() == "nccl":
        one = torch.ones(1, device=dev)
        dist.all_reduce(one)
        out["nccl_all_reduce"] = float(one)
    del state, step, trainer
    comm.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def parallel_path(torch, dense: dict, moe: dict, depth: int, device: str,
                  batch: int, seq: int, card: str) -> dict:
    """Phase 3x's code at any width: (a) the single-process baselines,
    (b) each schedule on two rank processes over gloo, (c) a one-rank
    world over NCCL on the card (gloo on the host). Each schedule's
    losses and its first step's summed gradients (every rank's
    :func:`grad_norms`) are held to its baseline's. Fatal on any
    disagreement; returns the baselines' losses and gradient norms,
    every run's results and (b)'s launches of 2.1-2.3 by route, summed
    over schedules and ranks."""
    import gc

    from pbs_tpu_torch.parallel.launch import RankPool

    common = dict(seed=PARALLEL_SEED, batch=batch, seq=seq,
                  steps=PARALLEL_STEPS, lr=TRAIN_LR)
    bases = {"dense": ("dense", dense),
             "shallow": ("dense", dict(dense, n_layers=depth)),
             "moe": ("moe", dict(moe, n_layers=depth))}
    base, base_norms = {}, {}
    for key, (family, fields) in bases.items():
        base[key], ms, base_norms[key] = parallel_baseline(
            torch, family, fields, device, **common)
        print(f"  (a) {key}: {fields['n_layers']} layers in one process, "
              f"losses {base[key]}, ms/step {[round(x, 1) for x in ms]} "
              f"[{card}]", flush=True)
    cfg = parallel_config(torch, "dense", dense)
    replica = cfg.num_params() * 16
    print(f"  a replica of {cfg.num_params() / 1e6:.1f}M params with fp32 "
          f"masters, gradients and two AdamW moments: "
          f"{replica / 1e9:.1f} GB; the ring's two replicas "
          f"{2 * replica / 1e9:.1f} GB plus activations [{card}]",
          flush=True)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    def holds(name, key, r):
        for i, (w, g) in enumerate(zip(base[key], r["losses"])):
            if r["rank"]:  # rank 0's losses, which every rank shares
                break
            tol = PARALLEL_TOL * max(1.0, abs(w))
            check(abs(g - w) <= tol and math.isfinite(g),
                  f"{name}: step {i} loss {g:.6f} within {tol:.2e} of the "
                  f"single-process {w:.6f} (|diff| {abs(g - w):.2e})")
        worst, where = grad_norm_diff(base_norms[key], r["grad_norms"])
        check(worst <= PARALLEL_GRAD_TOL,
              f"{name} rank {r['rank']}: the first step's summed "
              f"gradients, {len(r['grad_norms'])} leaves' norms per layer, "
              f"within rel {PARALLEL_GRAD_TOL:g} of the single-process "
              f"run's (worst {worst:.2e} at {where})")

    def report(name, res):
        for r in res:
            ex = r["exchanges"][-1]  # the last step: warm
            print(f"  {name} rank {r['rank']} ({r['backend']}, "
                  f"{r['device']}, block {r['block']}): ms/step "
                  f"{[round(x, 1) for x in r['ms']]}; the last step's "
                  f"{ex['exchanges']} exchanges {ex['seconds'] * 1e3:.1f} "
                  f"ms ({ex['seconds'] * 1e3 / r['ms'][-1]:.2f} of it), "
                  f"{ex['staged_bytes'] / 1e6:.1f} MB staged through the "
                  f"host; peak {r['peak_bytes'] / 2**30:.2f} GiB, launches "
                  f"{r['launches']} [{card}]", flush=True)

    runs = {}
    totals = {k: {"wgmma": 0, "simt": 0} for k in list(KERNELS)[:3]}
    with RankPool(2, backend="gloo", device=device) as pool:
        for r, diffs in enumerate(pool.run("chip_smoke:staged_exchanges",
                                           device, PARALLEL_SEED)):
            check(all(d == 0.0 for d in diffs.values()),
                  f"(b) rank {r}: each exchange on {device} tensors, "
                  f"forward and backward, equals gloo's on host copies "
                  f"(max |diff| {diffs})")
        for sched in parallel_schedules(dense, moe, depth):
            t0 = time.monotonic()
            res = pool.run("chip_smoke:parallel_rank_run", sched, device,
                           timeout_s=PARALLEL_RANK_TIMEOUT_S, **common)
            name = f"(b) {sched['name']} ({sched['cfg']['n_layers']} layers)"
            print(f"  {name}: {time.monotonic() - t0:.1f} s", flush=True)
            report(name, res)
            runs[sched["name"]] = res
            check(res[0]["losses"] == res[1]["losses"],
                  f"{name}: both ranks report one global loss")
            for r in res:
                holds(name, sched["base"], r)
                for k, by in r["launches"].items():
                    for route, n in by.items():
                        totals[k][route] += n
                if device == "cuda":
                    by = r["launches"]
                    check(by["flash_fwd"]["wgmma"] > 0 and all(
                        v["simt"] == 0 for v in by.values()),
                          f"{name} rank {r['rank']}: every launch of "
                          f"2.1-2.3 on the tensor-core route ({by})")

    backend = "nccl" if device == "cuda" else "gloo"
    one = dict(name=f"one-rank {backend} world", family="dense",
               axes={"dp": 1}, cfg=dict(dense, n_layers=depth),
               base="shallow")
    t0 = time.monotonic()
    with RankPool(1, backend=backend, device=device) as pool:
        res = pool.run("chip_smoke:parallel_rank_run", one, device,
                       timeout_s=PARALLEL_RANK_TIMEOUT_S, **common)
    name = f"(c) {one['name']} ({depth} layers)"
    print(f"  {name}: {time.monotonic() - t0:.1f} s", flush=True)
    report(name, res)
    check(res[0]["backend"] == backend, f"{name}: backend {backend}")
    if backend == "nccl":
        check(res[0].get("nccl_all_reduce") == 1.0,
              f"{name}: an NCCL all-reduce over the world of one")
    holds(name, "shallow", res[0])
    runs[one["name"]] = res
    return {"base": base, "base_norms": base_norms, "runs": runs,
            "launches": totals}


def run_parallel_path(torch, card: str) -> tuple[dict, dict]:
    """Phase 3x on the card: :func:`parallel_path` at the flagship's
    widths (bf16, remat "dots", flash attention) and 3e's MoE widths.
    Returns (b)'s launches and routes of the four kernels."""
    t_phase = time.monotonic()
    dense = dict(FLAGSHIP, dtype="bfloat16", remat=True,
                 remat_policy="dots", attn_impl="pallas")
    moe = dict(MOE, dtype="bfloat16", remat=True, attn_impl="pallas")
    out = parallel_path(torch, dense, moe, PARALLEL_DEPTH, "cuda",
                        TRAIN_BATCH, TRAIN_SEQ, card)
    routes = dict(out["launches"], instrumented_matmul={"wgmma": 0,
                                                        "simt": 0})
    launches = {k: sum(v.values()) for k, v in routes.items()}
    print(f"  (b) launches {launches}, by route {routes}", flush=True)
    print(f"  phase 3x wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, routes


# -- phase 3v ----------------------------------------------------------------


def serve_weights(torch, family: str, fields: dict, device, seed: int):
    """(config, full tree) of a phase-3v engine drawn from ``seed`` on
    ``device``: ``fields`` with ``dtype`` named; "dense" and "moe" the
    fp32 init cast to it, "int8" the fp32 init quantized (computed in
    ``dtype``, as 3s(d))."""
    from pbs_tpu_torch.models import (cast_params, init_moe_params,
                                      init_params, quantize_weights)

    cfg = parallel_config(torch, "moe" if family == "moe" else "dense",
                          fields)
    gen = torch.Generator(device=device).manual_seed(seed)
    init = init_moe_params if family == "moe" else init_params
    master = init(cfg, gen, device=device)
    if family == "int8":
        return cfg, quantize_weights(master)
    return cfg, cast_params(master, cfg.dtype)


def moe_cached_forward(cfg, params, tokens, cache):
    """The MoE lockstep forward for :func:`lockstep_margin`."""
    from pbs_tpu_torch.models.moe import moe_forward_with_cache

    return moe_forward_with_cache(cfg, params, tokens, cache)


def serve_gateway_run(be, reqs, arrivals, virtual: bool) -> dict:
    """The script through a port ``Gateway`` in front of the serve
    backend ``be``: each gateway tick submits its arrivals (explicit
    prompts, the budget as the cost, one interactive tenant that sheds
    nothing), then ticks once; a virtual clock advances 1 ms a tick.
    Returns the tokens by request index, each rid's index, each tick's
    host ms with whether it only decoded (an engine step that admitted
    nothing, no prompt into a prefill pool) and its exchanges
    (``comm.stats()``), the gateway and the wall seconds."""
    from pbs_tpu_torch.gateway import Gateway, TenantQuota
    from pbs_tpu_torch.parallel import comm
    from pbs_tpu_torch.utils.clock import MS, MonotonicClock, VirtualClock

    clock = VirtualClock() if virtual else MonotonicClock()
    gw = Gateway([be], clock=clock, trace_capacity=GW_TRACE_CAPACITY,
                 quotas={"serve": TenantQuota(rate=1e9, burst=1e9,
                                              slo="interactive",
                                              max_queued=len(reqs))})
    eng, pool = be.engine, getattr(be, "prefill_pool", None)
    index, tokens, stepped = {}, {}, []
    engine_step = eng.step

    def recording_step():
        out = engine_step()
        stepped.append(len(eng._admitted))
        for c in out:  # poll pops the engine id after step returns
            rid = be._by_engine_rid[c.request_id].rid
            tokens[index[rid]] = list(c.tokens)
        return out

    eng.step = recording_step
    limit = max(arrivals) + 4 * sum(n for _, n in reqs)
    ticks, tick = [], 0
    t0 = time.monotonic()
    try:
        while tick <= max(arrivals) or gw.busy():
            if tick > limit:
                raise Failed(f"{be.name}: the gateway still busy after "
                             f"{limit} ticks")
            for i in arrivals.get(tick, []):
                prompt, n = reqs[i]
                r = gw.submit("serve", {"prompt": prompt, "max_new": n},
                              cost=n)
                if not r.admitted:
                    raise Failed(f"{be.name}: request {i} shed "
                                 f"({r.reason})")
                index[r.rid] = i
            ingested = pool.prompts_ingested if pool is not None else 0
            stepped.clear()
            comm.reset_stats()
            t = time.monotonic()
            gw.tick()
            ms = (time.monotonic() - t) * 1e3
            decode = stepped == [0] and (
                pool is None or pool.prompts_ingested == ingested)
            ticks.append((ms, decode, comm.stats()))
            if virtual:
                clock.advance(MS)
            tick += 1
    finally:
        eng.step = engine_step
    return dict(tokens=tokens, index=index, ticks=ticks, gw=gw,
                wall=time.monotonic() - t0)


def serve_spans_check(what: str, run: dict) -> None:
    """One gapless span chain per admitted request, none lost."""
    from pbs_tpu_torch.obs import SpanAssembler

    gw = run["gw"]
    recs = gw.trace.consume(GW_TRACE_CAPACITY)
    asm = SpanAssembler(recs, gw.spans.rid_table(), gw.spans.member_table(),
                        gw.spans.tenant_table())
    problems = asm.validate(sorted(run["index"]))
    summary = asm.summary()
    check(gw.trace.lost == 0 and not problems
          and summary["chains"] == len(run["index"]),
          f"{what}: one gapless span chain per request "
          f"({summary['chains']} of {len(run['index'])}, trace records "
          f"lost {gw.trace.lost}); problems {problems[:3]}")


def decode_ticks(run: dict) -> list:
    return [(ms, ex) for ms, decode, ex in run["ticks"] if decode]


def serve_line(what: str, st: dict, run: dict, card: str,
               extra: str = "") -> str:
    """One serve backend's numbers: TTFT and latency p50/p99 from its
    engine's stats (host clock), the median decode tick (a gateway tick
    in which the engine only decoded), tokens/s over the run."""
    dec = [ms for ms, _ in decode_ticks(run)]
    tok_s = st["tokens_emitted"] / run["wall"]
    return (f"  {what}: completed {st['completed']}, prefix hits "
            f"{st['prefix_hits']}; TTFT p50 {st['ttft_p50_s'] * 1e3:.2f} / "
            f"p99 {st['ttft_p99_s'] * 1e3:.2f} ms, latency p50 "
            f"{st['latency_p50_s'] * 1e3:.2f} / p99 "
            f"{st['latency_p99_s'] * 1e3:.2f} ms; decode tick "
            f"{statistics.median(dec):.2f} ms (median of {len(dec)} of "
            f"{len(run['ticks'])} gateway ticks); {tok_s:.1f} tok/s over "
            f"{run['wall']:.2f} s{extra} [{card}]")


def bitwise_equal_trees(a, b) -> bool:
    """Two param trees with the same leaves, dtypes, shapes and bytes."""
    import torch

    from pbs_tpu_torch.models.transformer import tree_leaves

    def raw(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(raw(x), raw(y)) for x, y in zip(la, lb))


def probe_logits(torch, eng, reqs):
    """The fp32 last-position logits of prefills of the script's first
    SERVE_PROBES prompts into slot 0 of an idle engine, which is left
    free (numpy, one row a prompt)."""
    import numpy as np

    out = []
    for prompt, _ in reqs[:SERVE_PROBES]:
        padded = np.zeros(eng.bucket, np.int32)
        padded[:len(prompt)] = prompt
        out.append(eng._prefill(0, padded, len(prompt))[1].float().cpu()
                   .numpy())
        eng.cache["pos"][0] = 0
    return np.stack(out)


def tp_tie(got, want) -> float:
    """The relative top-2 gap two engines' probe logits (``got`` against
    ``want``, one row a prompt) can close: twice their largest
    difference over the smallest top logit."""
    import numpy as np

    return float(2 * np.abs(got - want).max()
                 / np.abs(want.max(axis=1)).min())


def serve_rank_run(family: str, fields: dict, device: str, seed: int,
                   reqs, arrivals) -> dict:
    """Phase 3v (c) on one rank process: the seed's full tree, kept as
    this rank's blocks by ``ShardedServeBackend`` at tp over the whole
    world behind a virtual-clock gateway, 3s's script. Returns the
    probe prompts' prefill logits (:func:`probe_logits`, on the fresh
    engine), the tokens, the backend's stats, the median decode tick and its
    exchanges (``comm.stats()``: count, bytes staged through the host,
    host seconds), a prefill's ms, the peak device memory while serving
    and the kernels' launches; then frees the engine and the pinned
    staging buffers."""
    import torch
    import torch.distributed as dist

    from pbs_tpu_torch.parallel import comm
    from pbs_tpu_torch.parallel.mesh import rank_device
    from pbs_tpu_torch.serve import ShardedServeBackend

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device(device)
    cfg, params = serve_weights(torch, family, fields, dev, seed)
    wrappers = bwd_counts()
    reset_counts(wrappers)
    t = time.monotonic()
    be = ShardedServeBackend(
        f"tp-{family}", cfg, params, tp=dist.get_world_size(),
        n_slots=ENGINE_SLOTS, prompt_bucket=ENGINE_BUCKET,
        max_len=ENGINE_MAX_LEN, prefix_cache_size=ENGINE_PREFIX,
        seed=seed, clock="virtual", device=device)
    del params
    built_s = time.monotonic() - t
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    logits = probe_logits(torch, be.engine, reqs)
    run = serve_gateway_run(be, reqs, arrivals, virtual=True)
    dec = decode_ticks(run)
    out = dict(rank=dist.get_rank(), device=str(dev), tokens=run["tokens"],
               logits=logits,
               stats=be.stats(), built_s=built_s, wall=run["wall"],
               ticks=len(run["ticks"]), decode_ticks=len(dec),
               decode_ms=statistics.median(ms for ms, _ in dec),
               exchanges=statistics.median(ex["exchanges"] for _, ex in dec),
               staged_bytes=statistics.median(ex["staged_bytes"]
                                              for _, ex in dec),
               exchange_ms=statistics.median(ex["seconds"] * 1e3
                                             for _, ex in dec),
               prefill_ms=time_prefill(torch, be.engine, reqs[0][0]),
               local_kv_heads=int(be.engine.cache["k"].shape[3]),
               peak_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else 0),
               launches=control_launches(wrappers))
    del be, run
    comm.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def serve_children(demo_device: str | None) -> dict:
    """Phase 3v (d): ``pbst-torch serve stats``, ``serve demo`` and
    ``serve demo --disagg`` in three child interpreters at once."""
    from concurrent.futures import ThreadPoolExecutor

    dev = ["--device", demo_device] if demo_device else []
    demo = ["serve", "demo", "--requests", str(SERVE_DEMO_REQUESTS), *dev]
    args = {"stats": ["serve", "stats"], "demo": demo,
            "disagg": [*demo, "--disagg"]}
    with ThreadPoolExecutor(len(args)) as ex:
        futs = {k: ex.submit(pbst_child, a, timeout=SERVE_CHILD_TIMEOUT_S)
                for k, a in args.items()}
        return {k: f.result() for k, f in futs.items()}


def serve_path(torch, cfg, params, a_tokens: dict, reqs, arrivals,
               dense: dict, moe: dict, depth: int, device: str, card: str,
               demo_device: str | None = None) -> dict:
    """Phase 3v's code at any width: (a) ``ShardedServeBackend`` at 1x1
    over ``cfg``/``params`` behind the gateway, its tokens against
    ``a_tokens`` (a direct engine's on the same weights); (b)
    ``DisaggServeBackend`` on the same script against (a); (c) the tp
    engines on two rank processes over gloo, ``dense`` at its depth and
    its int8 twin and ``moe`` (dropless) at ``depth`` layers, each
    against one process's engine on the same weights; (d) the serve
    command in child processes. Fatal on any disagreement. Returns
    (a)+(b)'s launches of the four kernels and (c)'s (both ranks), by
    route, and the numbers printed."""
    import gc

    from pbs_tpu_torch.models import ContinuousBatcher
    from pbs_tpu_torch.models.moe import moe_slot_mlp
    from pbs_tpu_torch.parallel.launch import RankPool
    from pbs_tpu_torch.serve import DisaggServeBackend, ShardedServeBackend

    kw = dict(n_slots=ENGINE_SLOTS, prompt_bucket=ENGINE_BUCKET,
              max_len=ENGINE_MAX_LEN)
    n = len(reqs)

    def budgets_ok(toks: dict) -> bool:  # every request, its budget
        return sorted(toks) == list(range(n)) and all(
            len(toks[i]) == reqs[i][1] for i in toks)

    wrappers = bwd_counts()
    reset_counts(wrappers)
    lines = {}

    # (a) the rule-partitioned backend at 1x1
    be = ShardedServeBackend("serve-a", cfg, params, tp=1, dp=1,
                             prefix_cache_size=ENGINE_PREFIX, device=device,
                             **kw)
    a = serve_gateway_run(be, reqs, arrivals, virtual=False)
    st, gst = be.stats(), a["gw"].stats()
    check(st["mesh"] == {"dp": 1, "tp": 1},
          f"(a) stats()['mesh'] == {st['mesh']}")
    check(st["completed"] == gst["completed"] == n and budgets_ok(a["tokens"])
          and st["bypass_submits"] == gst["bypass_submits"] == 0,
          f"(a) all {n} requests completed through the gateway with their "
          f"budgets; bypass submits {st['bypass_submits']}")
    serve_spans_check("(a)", a)
    ties = compare_tokens(torch, cfg, params, reqs, a["tokens"], a_tokens,
                          "(a) vs the direct engine")
    check(bitwise_equal_trees(params, be.gather_params()),
          f"(a) gather_params() is the tree passed in, bit for bit "
          f"({st['param_leaves']} leaves, {st['param_bytes']} bytes)")
    lines["a"] = serve_line(
        "(a) ShardedServeBackend 1x1", st, a, card,
        f"; prefill {time_prefill(torch, be.engine, reqs[0][0]):.2f} ms; "
        f"near-ties {ties}")
    print(lines["a"], flush=True)
    del be
    a_toks = a["tokens"]

    # (b) prefill/decode disaggregation on the same script, with (a)'s
    # decode slots
    lanes = ENGINE_SLOTS + SERVE_PREFILL_LANES
    be = DisaggServeBackend("serve-b", cfg, params, n_slots=lanes,
                            split=SERVE_PREFILL_LANES / lanes,
                            prompt_bucket=ENGINE_BUCKET,
                            max_len=ENGINE_MAX_LEN, device=device)
    b = serve_gateway_run(be, reqs, arrivals, virtual=False)
    st = be.stats()
    check(st["completed"] == n and budgets_ok(b["tokens"])
          and st["decode_pool_prefills"] == 0
          and st["handoffs"] == st["completed"]
          and st["bypass_submits"] == 0
          and st["pools"] == {"prefill_lanes": SERVE_PREFILL_LANES,
                              "decode_slots": ENGINE_SLOTS},
          f"(b) all {n} requests completed, decode_pool_prefills "
          f"{st['decode_pool_prefills']} == 0, handoffs {st['handoffs']} "
          f"== completed {st['completed']} ({st['pools']})")
    serve_spans_check("(b)", b)
    ties = compare_tokens(torch, cfg, params, reqs, b["tokens"], a_toks,
                          "(b) vs (a)")
    lines["b"] = serve_line(
        "(b) DisaggServeBackend", st, b, card,
        f"; {st['prompts_prefilled']} prompts prefilled in its pool, "
        f"{st['handoffs']} handoffs; near-ties {ties}")
    print(lines["b"], flush=True)
    del be, a, b
    ab_launches = control_launches(wrappers)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # (c) tensor-parallel engines on two rank processes: dense, int8 and
    # MoE in bf16, then the dense one in fp32, token-exact as 3s (b)
    engines = [("dense", "dense", dense),
               ("int8", "int8", dict(dense, n_layers=depth)),
               ("moe", "moe", dict(moe, n_layers=depth, dropless=True)),
               ("fp32", "dense", dict(dense, n_layers=depth,
                                      dtype="float32"))]
    c_launches = {k: 0 for k in KERNELS}
    c_routes = {k: {"wgmma": 0, "simt": 0} for k in KERNELS}
    runs = {}
    with RankPool(2, backend="gloo", device=device) as pool:
        for label, family, fields in engines:
            name = (f"(c) tp2 {label}, {fields['dtype']}, "
                    f"{fields['n_layers']} layers")
            t0 = time.monotonic()
            res = pool.run("chip_smoke:serve_rank_run", family, fields,
                           device, SERVE_SEED, reqs, arrivals,
                           timeout_s=PARALLEL_RANK_TIMEOUT_S)
            wall = time.monotonic() - t0
            check(res[0]["tokens"] == res[1]["tokens"]
                  and budgets_ok(res[0]["tokens"])
                  and (res[0]["logits"] == res[1]["logits"]).all(),
                  f"{name}: both ranks' {n} completions and probe logits "
                  f"identical, with their budgets")
            ccfg, cparams = serve_weights(torch, family, fields, device,
                                          SERVE_SEED)
            mlp = {"mlp_fn": moe_slot_mlp(ccfg)} if family == "moe" else {}
            eng = ContinuousBatcher(ccfg, cparams, device=device,
                                    prefix_cache_size=ENGINE_PREFIX,
                                    seed=SERVE_SEED, **kw, **mlp)
            want = probe_logits(torch, eng, reqs)
            dev_std = float(abs(res[0]["logits"] - want).max() / want.std())
            check(dev_std <= SERVE_TP_LOGITS,
                  f"{name}: the {SERVE_PROBES} probe prefills' logits "
                  f"against one process's, max|diff| / std = "
                  f"{dev_std:.3e} <= {SERVE_TP_LOGITS}")
            one = drive_engine(torch, eng, reqs, arrivals)
            tie = ENGINE_TIE if fields["dtype"] == "float32" \
                else tp_tie(res[0]["logits"], want)
            ties = compare_tokens(
                torch, ccfg, cparams, reqs, res[0]["tokens"],
                {i: c.tokens for i, c in one["done"].items()},
                f"{name} vs one process",
                moe_cached_forward if family == "moe" else None, tie)
            one_ms = decode_tick_ms(one["ticks"])
            one_prefill = time_prefill(torch, eng, reqs[0][0])
            print(f"  {name}: {wall:.1f} s; one process: decode tick "
                  f"{one_ms:.2f} ms, prefill {one_prefill:.2f} ms; probe "
                  f"logits max|diff| / std {dev_std:.3e}; {len(ties)} "
                  f"divergences, each a near-tie within {tie:g}: {ties} "
                  f"[{card}]", flush=True)
            for r in res:
                print(f"  {name} rank {r['rank']} ({r['device']}, "
                      f"{r['local_kv_heads']} of {fields['n_kv_heads']} kv "
                      f"heads): built {r['built_s']:.2f} s; decode tick "
                      f"{r['decode_ms']:.2f} ms (median of "
                      f"{r['decode_ticks']} of {r['ticks']}), "
                      f"{r['exchanges']:.0f} exchanges "
                      f"{r['exchange_ms']:.2f} ms and "
                      f"{r['staged_bytes'] / 1e6:.3f} MB staged through "
                      f"the host a decode tick; prefill "
                      f"{r['prefill_ms']:.2f} ms; TTFT p50/p99 "
                      f"{r['stats']['ttft_p50_s'] * 1e3:.1f} / "
                      f"{r['stats']['ttft_p99_s'] * 1e3:.1f} ms (virtual "
                      f"clock, 1 ms a tick); peak "
                      f"{r['peak_bytes'] / 2**30:.2f} GiB [{card}]",
                      flush=True)
                launches, routes = r["launches"]
                for k in KERNELS:
                    c_launches[k] += launches[k]
                    for route, m in routes[k].items():
                        c_routes[k][route] += m
            runs[label] = dict(ranks=res, one_ms=one_ms,
                               one_prefill_ms=one_prefill, ties=ties,
                               logits_dev=dev_std)
            del eng, cparams, one
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()

    # (d) the serve command in child processes
    kids = serve_children(demo_device)
    outs = {}
    for k, r in kids.items():
        check(r["rc"] == 0, f"(d) pbst-torch serve {k}: rc {r['rc']} "
                            f"({r['wall']:.1f} s) {r['err'][-300:]}")
        outs[k] = json.loads(r["out"])
    check(outs["stats"]["audit"] == {"dead": [], "shadowed": [],
                                     "uncovered": []},
          f"(d) serve stats: the audit is empty ({outs['stats']['audit']})")
    for k in ("demo", "disagg"):
        sv = outs[k]["serve"]
        check(outs[k]["completions"] == SERVE_DEMO_REQUESTS
              and sv["bypass_submits"] == 0
              and sv.get("decode_pool_prefills", 0) == 0,
              f"(d) serve {k}: {outs[k]['completions']} completions, "
              f"bypasses {sv['bypass_submits']}, decode-pool prefills "
              f"{sv.get('decode_pool_prefills', '-')}")
    print(f"  (d) children: " + ", ".join(
        f"{k} {r['wall']:.1f} s" for k, r in kids.items()), flush=True)
    return dict(ab_launches=ab_launches, c_launches=(c_launches, c_routes),
                runs=runs, lines=lines, children=outs)


def run_serve_path(torch, cfg, params, a_tokens: dict, card: str):
    """Phase 3v on the card: :func:`serve_path` over phase 3's bf16
    flagship tree and 3s(a)'s tokens, (c) at the flagship's widths
    (bf16; the MoE at 3e's). Returns the four kernels' launches and
    routes over (a)-(c)."""
    t_phase = time.monotonic()
    reqs, arrivals = engine_script()
    out = serve_path(torch, cfg, params, a_tokens, reqs, arrivals,
                     dict(FLAGSHIP, dtype="bfloat16"),
                     dict(MOE, dtype="bfloat16"), PARALLEL_DEPTH, "cuda",
                     card)
    (ab, ab_routes), (c, c_routes) = out["ab_launches"], out["c_launches"]
    launches = {k: ab[k] + c[k] for k in KERNELS}
    routes = {k: {r: ab_routes[k][r] + c_routes[k][r] for r in c_routes[k]}
              for k in KERNELS}
    print(f"  launches (a)-(c) {launches}, by route {routes}", flush=True)
    print(f"  phase 3v wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, routes


# -- phase 3b ----------------------------------------------------------------


def longctx_points(torch, card: str) -> dict:
    """Phase 3b (b): :data:`LONGCTX_POINTS` through ``bench_longctx``'s
    ``measure_point`` on the card, the flash kernels' launches counted
    per point from 0. Returns, per (seq, attn), the row, the raw
    measurement and the launches by kernel and route."""
    from pbs_tpu_torch.drivers import bench_longctx
    from pbs_tpu_torch.drivers.bench_common import release
    from pbs_tpu_torch.drivers.graft_entry import _flagship_cfg

    wrappers = bwd_counts()
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "instrumented_matmul")
    cfg = _flagship_cfg()
    out = {}
    for seq, batch, attn in LONGCTX_POINTS:
        release("cuda")
        reset_counts(wrappers)
        row, m = bench_longctx.measure_point(
            cfg, seq, batch, attn, warm_chunks=1, timed_chunks=1,
            device="cuda", steps=LONGCTX_STEPS)
        torch.cuda.synchronize()
        counts = {n: w.launches for n, w in zip(names, wrappers)}
        routes = {n: dict(w.launches_by_route)
                  for n, w in zip(names, wrappers)}
        steps = 2 * LONGCTX_STEPS
        per_step = (24, 12, 12, 0) if attn == "pallas" else (0, 0, 0, 0)
        want = {n: k * steps for n, k in zip(names, per_step)}
        on_tc = all(routes[n]["simt"] == 0 for n in names)
        check(counts == want and on_tc and math.isfinite(m["loss"])
              and math.isfinite(m["first_loss"]),
              f"longctx {attn} ({seq}, {batch}): {steps} steps, launches "
              f"{counts} == {want} (24 / 12 / 12 a step for the flash "
              f"column), all \"wgmma\" {on_tc}, losses {m['first_loss']:.4f}"
              f" -> {m['loss']:.4f} finite")
        print(f"    {json.dumps(row)}; peak {m['peak_gib']:.2f} GiB "
              f"allocated [{card}]", flush=True)
        out[(seq, attn)] = dict(row=row, m=m, launches=counts,
                                routes=routes)
    release("cuda")
    for seq in sorted({s for s, _ in out}):
        cols = {a: out[(s, a)] for s, a in out if s == seq}
        if {"xla", "pallas"} <= set(cols):
            fl, dl = (cols[a]["m"]["first_loss"] for a in ("pallas", "xla"))
            rel = abs(fl - dl) / abs(dl)
            check(rel < LONGCTX_LOSS_REL,
                  f"longctx ({seq}): first-step loss, flash {fl:.5f} vs "
                  f"dense {dl:.5f} on the same params and tokens, rel "
                  f"{rel:.2e} < {LONGCTX_LOSS_REL:g}")
            print(f"    pallas_speedup at {seq}: "
                  f"{cols['pallas']['m']['tokens_per_s'] / cols['xla']['m']['tokens_per_s']:.3f}"
                  f" (tokens/s {cols['pallas']['m']['tokens_per_s']:.1f} vs "
                  f"{cols['xla']['m']['tokens_per_s']:.1f})", flush=True)
    return out


def bench_child(args=(), env=None, timeout: float = BENCH_CHILD_TIMEOUT_S):
    """``python -m pbs_tpu_torch.drivers.bench ARGS`` as the driver runs
    it: no ``PBST_BENCH_*`` knob but those in ``env``. Returns its exit
    code, its last JSON line (None without one), stdout, stderr and wall
    seconds."""
    repo = os.path.dirname(os.path.abspath(__file__))
    child_env = {k: v for k, v in os.environ.items()
                 if not k.startswith("PBST_BENCH_")}
    child_env.update(PYTHONPATH=repo, **(env or {}))
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pbs_tpu_torch.drivers.bench", *args],
        cwd=repo, env=child_env, capture_output=True, text=True,
        timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return dict(rc=proc.returncode, row=json.loads(lines[-1]) if lines
                else None, out=proc.stdout, err=proc.stderr,
                wall=time.monotonic() - t)


def pid_running(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie waiting for its reaper does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


#: (f4)'s stub worker (and the CPU tests'): a child of its own, both
#: pids written to the file its first argument names, the backend
#: marker, then a stall past the deadline.
STALL_WORKER = (
    "import os, subprocess, sys, time\n"
    "kid = subprocess.Popen([sys.executable, '-c', "
    "'import time; time.sleep(120)'])\n"
    "open(sys.argv[1], 'w').write(f'{os.getpid()} {kid.pid}')\n"
    "sys.stderr.write('[bench +  1.0s] backend init: stub\\n')\n"
    "sys.stderr.write('[bench +  1.1s] compiling train chunk\\n')\n"
    "sys.stderr.flush()\n"
    "time.sleep(120)\n"
)


def bench_fault_paths(card: str) -> None:
    """(f4): the supervisor with no visible card, and with a stub worker
    that stalls past its deadline."""
    import shutil
    import tempfile

    from pbs_tpu_torch.drivers.bench import KILL_GRACE_S

    nocard = bench_child(env={"CUDA_VISIBLE_DEVICES": ""})
    row = nocard["row"] or {}
    check(nocard["rc"] == 1 and row.get("metric") ==
          "flagship_train_throughput" and row.get("value") == 0.0
          and str(row.get("error", "")).startswith("backend unavailable:")
          and nocard["err"].count("importing torch") == 1
          and "gateway_serving_throughput" not in nocard["out"],
          f"(f4) no visible card: rc {nocard['rc']}, the error row "
          f"{str(row.get('error'))[:110]!r}, one attempt, no serving "
          f"number, {nocard['wall']:.1f} s [{card}]")
    tmp = tempfile.mkdtemp(prefix="bench_stall_")
    try:
        stub, pids = os.path.join(tmp, "stub.py"), os.path.join(tmp, "pids")
        with open(stub, "w") as f:
            f.write(STALL_WORKER)
        stalled = bench_child(env={
            "PBST_BENCH_WORKER_CMD": f"{sys.executable} {stub} {pids}",
            "PBST_BENCH_TIMEOUT_S": str(BENCH_STALL_DEADLINE_S)})
        with open(pids) as f:
            procs = [int(p) for p in f.read().split()]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = stalled["row"] or {}
    left = [p for p in procs if pid_running(p)]
    check(stalled["rc"] == 1 and str(row.get("error", "")).startswith(
              f"deadline after {BENCH_STALL_DEADLINE_S}s; last stage: ")
          and "compiling train chunk" in row["error"] and not left
          and stalled["wall"] < BENCH_STALL_DEADLINE_S + KILL_GRACE_S + 15,
          f"(f4) a stub stalled past a {BENCH_STALL_DEADLINE_S} s deadline: "
          f"the error names its last stage, worker and child {procs} gone "
          f"(left {left}) in {stalled['wall']:.1f} s [{card}]")


def run_bench_twin(torch, card: str, device: str = "cuda"):
    """Phase 3b (f) (the module docstring). On ``device="cpu"`` the same
    code runs the twin's tiny mode on the host (its CPU twin in
    tier-1), where no kernel launches. Returns (f2)'s launches and
    routes."""
    from pbs_tpu_torch.drivers import bench
    from pbs_tpu_torch.drivers.bench_common import release
    from pbs_tpu_torch.drivers.graft_entry import _flagship_cfg

    on_card = device == "cuda"
    tiny = {} if on_card else {"PBST_BENCH_TINY": "1"}
    # The tiny model's MFU on the host rounds to 0.0.
    mfu_ok = (lambda m: 0 < m <= 1) if on_card else (lambda m: m == 0.0)
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    cfg = _flagship_cfg(tiny=not on_card)
    n_params = cfg.num_params()
    if on_card:
        # phase 2 held 2.1-2.3 to their plain versions at (f2)'s call
        check(BENCH_FLASH_SHAPE == (bench.BATCH, bench.SEQ - 1, cfg.n_heads,
                                    cfg.n_kv_heads,
                                    cfg.d_model // cfg.n_heads),
              f"(f2)'s flash call {BENCH_FLASH_SHAPE} is phase 2's "
              f"BENCH_FLASH_SHAPE")
    release(device)

    print("  (f1) the headline, as the driver runs it", flush=True)
    head = bench_child(env=tiny)
    row = head["row"] or {}
    check(head["rc"] == 0 and "error" not in row
          and row.get("metric") == "flagship_train_throughput"
          and row.get("value", 0) > 0 and mfu_ok(row.get("mfu"))
          and math.isfinite(row.get("loss", math.nan))
          and row.get("n_params") == n_params and row.get("device") == name,
          f"(f1) drivers.bench: rc {head['rc']}, "
          f"{row.get('metric')} {row.get('value')} tokens/s, step "
          f"{row.get('step_ms')} ms, mfu {row.get('mfu')}, n_params "
          f"{row.get('n_params')}, on {row.get('device')!r} in "
          f"{head['wall']:.1f} s" + ("" if head["rc"] == 0 else
                                     f"\n{head['err'][-1500:]}"))
    print(f"    {json.dumps(row)} [{card}]", flush=True)

    print("  (f2) its worker body here, attn \"pallas\"", flush=True)
    wrappers = bwd_counts()
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "instrumented_matmul")
    knobs = {**bench.parse_knobs(not on_card), "attn": "pallas"}
    reset_counts(wrappers)
    flash, first_loss = bench.measure(knobs, tiny=not on_card,
                                      device=device,
                                      t_start=time.perf_counter())
    if on_card:
        torch.cuda.synchronize()
    launches = {n: w.launches for n, w in zip(names, wrappers)}
    routes = {n: dict(w.launches_by_route) for n, w in zip(names, wrappers)}
    steps = ((bench.WARMUP_CHUNKS + bench.BENCH_CHUNKS)
             * bench.STEPS_PER_CHUNK if on_card else 0)
    want = {n: k * steps for n, k in zip(names, (24, 12, 12, 0))}
    on_tc = all(routes[n]["simt"] == 0 for n in names)
    check(launches == want and on_tc and flash["value"] > 0
          and mfu_ok(flash["mfu"]) and flash["attn"] == "pallas"
          and "degraded_protocol" not in flash
          and math.isfinite(flash["loss"]) and flash["loss"] < first_loss,
          f"(f2) attn \"pallas\": {steps} steps, launches {launches} == "
          f"{want} (24 / 12 / 12 a step), all \"wgmma\" {on_tc}; "
          f"{flash['value']} tokens/s, step {flash['step_ms']} ms, mfu "
          f"{flash['mfu']}; loss {first_loss:.4f} -> {flash['loss']}")
    check(row["loss"] < first_loss,
          f"(f1) loss {row['loss']} below the first step's, {first_loss:.4f} "
          f"(f2's: the same seeded params and tokens)")
    print(f"    tokens/s: (f1) xla {row['value']}, (f2) pallas "
          f"{flash['value']} [{card}]", flush=True)
    release(device)

    # (f3) alone: its host-paced ticks are timed with no other child
    # running
    print("  (f3) --serving-fallback", flush=True)
    served = bench_child(["--serving-fallback"]
                         + ([] if on_card else ["--device", "cpu"]))
    srow = served["row"] or {}
    check(served["rc"] == 0
          and srow.get("metric") == "gateway_serving_throughput"
          and srow.get("completions") == srow.get("requests") == 32
          and srow.get("device") == name,
          f"(f3) serving mode: rc {served['rc']}, {srow.get('completions')}"
          f" of {srow.get('requests')} requests, {srow.get('value')} "
          f"tokens/s, p99 {srow.get('p99_latency_ms')} ms on "
          f"{srow.get('device')!r}" + ("" if served["rc"] == 0 else
                                       f"\n{served['err'][-1500:]}"))
    print("  (f4) the fault paths", flush=True)
    bench_fault_paths(card)
    return launches, routes


def run_drivers_path(torch, card: str):
    """Phase 3b on the card: (a)-(e) of the module docstring. Returns the
    four kernels' launches and routes over the phase (all of them (b)'s
    flash column), and (b)'s launches per long-context shape."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from pbs_tpu_torch.drivers import bench_serving, graft_entry
    from pbs_tpu_torch.drivers.bench_common import release

    t_phase = time.monotonic()
    reset_counts(bwd_counts())
    fn, (params, tokens) = graft_entry.entry()
    t0 = time.monotonic()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    check(tuple(logits.shape) == (4, 256, 32768)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          f"(a) entry(): flagship forward on zeros (4, 256) -> logits "
          f"{tuple(logits.shape)} {str(logits.dtype)[6:]}, finite, "
          f"{ms:.1f} ms with its first call [{card}]")
    del fn, params, tokens, logits
    release("cuda")

    print("  (b) long-context training path", flush=True)
    points = longctx_points(torch, card)

    print("  (c) bench_serving rows", flush=True)
    sz = bench_serving.sizes(False)
    cfg, params, prompt = bench_serving.setup(False, "cuda")
    row, prefill_ms = bench_serving.prefill_row(cfg, params, prompt,
                                                sz["new_tokens"], "cuda",
                                                reps=5)
    print(f"    {json.dumps(row)}", flush=True)
    drow = bench_serving.decode_row(cfg, params, prompt, sz["new_tokens"],
                                    "cuda", prefill_ms, iters=1)
    print(f"    {json.dumps(drow)}", flush=True)
    check(row["value"] > 0 and drow["value"] > 0,
          f"(c) prefill {row['value']} ms at ({sz['batch']}, "
          f"{sz['prompt_len']}), decode {drow['value']} tokens/s over "
          f"{sz['new_tokens']} new tokens")
    names = ("continuous_bf16", "continuous_moe_dropless")
    rows, _ = bench_serving.run_engines(
        bench_serving.engine_factories(cfg, params, "cuda", sz), names,
        bench_serving.engine_prompts(sz["n_slots"]), sz["eng_new"], "cuda")
    check(all("error" not in r and r["requests"] == 2 * sz["n_slots"]
              for r in rows),
          f"(c) engines {list(names)}: every request completed, no error "
          f"row [{card}]")
    del cfg, params, prompt
    release("cuda")

    print("  (d) dryrun_multichip(8) on the host's CPU, (e) the "
          "walkthroughs on the card beside it", flush=True)
    tmp, _ = paging_dir("3b")
    try:
        with ThreadPoolExecutor(len(EXAMPLES)) as ex:
            kids = {n: ex.submit(
                pbst_child, ["--workdir", tmp] if n == "train_from_text"
                else [], timeout=EXAMPLE_TIMEOUT_S,
                module=f"pbs_tpu_torch.examples.{n}") for n in EXAMPLES}
            dry = graft_entry.dryrun_multichip(8, budget_s=DRYRUN_BUDGET_S)
            kids = {n: f.result() for n, f in kids.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_run = len(dry["losses"])
    check(n_run + len(dry["skipped"]) == 11 and n_run >= 4,
          f"(d) dryrun_multichip(8): {n_run} of 11 schedules ran, skipped "
          f"{dry['skipped'] or 'none'} (budget {DRYRUN_BUDGET_S} s)")
    for n, k in kids.items():
        tail = " | ".join(k["out"].strip().splitlines()[-2:])
        check(k["rc"] == 0,
              f"(e) examples.{n}: rc {k['rc']} in {k['wall']:.1f} s: "
              f"{tail[:200]}" + (f"\n{k['err'][-1500:]}" if k["rc"] else ""))

    print("  (f) the headline bench's twin", flush=True)
    f_launches, f_routes = run_bench_twin(torch, card)

    per_shape = {}
    for shape in LONGCTX_FLASH_SHAPES:
        p = points[(shape[1] + 1, "pallas")]
        per_shape[shape[:2]] = (p["launches"], p["routes"])
    runs = [(p["launches"], p["routes"]) for p in points.values()]
    runs.append((f_launches, f_routes))
    launches = {k: sum(n[k] for n, _ in runs) for k in KERNELS}
    routes = {k: {r: sum(rt[k][r] for _, rt in runs)
                  for r in ("wgmma", "simt")} for k in KERNELS}
    print(f"  launches (a)-(f) {launches}, by route {routes}", flush=True)
    print(f"  phase 3b wall {time.monotonic() - t_phase:.1f} s [{card}]",
          flush=True)
    return launches, routes, per_shape


# -- phase 4 -----------------------------------------------------------------


def check_numerics(torch, gen, cfg, params) -> None:
    from pbs_tpu_torch.models import forward, forward_with_cache, init_cache

    tokens = torch.randint(0, cfg.vocab, (SCORE_BATCH, SCORE_SEQ),
                           device="cuda", generator=gen)
    with torch.no_grad():
        flash = forward(dataclasses.replace(cfg, attn_impl="pallas"), params,
                        tokens)
        dense = forward(cfg, params, tokens)
        finite = bool(torch.isfinite(flash).all())
        err = max_abs(flash, dense)
        rel = rel_err(flash, dense)
        del flash
        check(finite and tuple(dense.shape) == (SCORE_BATCH, SCORE_SEQ,
                                                cfg.vocab) and rel < 0.05,
              f"score logits, flash vs dense attention at width (bf16): "
              f"finite, max abs diff {err:.3e}, rel {rel:.3e} < 0.05")
        prompt = tokens[:, :SERVE_PROMPT]
        cache = init_cache(cfg, SCORE_BATCH, max_len=SERVE_PROMPT + 1,
                           device="cuda")
        cached, cache = forward_with_cache(cfg, params, prompt, cache)
        full = forward(cfg, params, prompt)
        rel = rel_err(cached, full)
        check(cache["pos"] == SERVE_PROMPT and rel < 0.05,
              f"KV-cache prefill vs full forward (bf16): rel {rel:.3e} "
              f"< 0.05")


def named_leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from named_leaves(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


def check_train_numerics(torch, gen, cfg, params) -> None:
    """One micro-batch's loss and gradients through the flash kernels
    against the dense attention path, bf16 compute, same weights."""
    from pbs_tpu_torch.models.transformer import loss_and_grads

    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                           device="cuda", generator=gen)
    loss_f, g_f = loss_and_grads(cfg, params, tokens)
    loss_d, g_d = loss_and_grads(dataclasses.replace(cfg, attn_impl="xla"),
                                 params, tokens)
    loss_f, loss_d = float(loss_f), float(loss_d)
    rel_loss = abs(loss_f - loss_d) / abs(loss_d)
    check(math.isfinite(loss_f) and rel_loss < 1e-2,
          f"train loss, flash vs dense attention at width (bf16): "
          f"{loss_f:.5f} vs {loss_d:.5f}, rel {rel_loss:.2e} < 1e-2")
    dense = dict(named_leaves(g_d))
    rels = {}
    for name, g in named_leaves(g_f):
        d = dense[name]
        rels[name] = float(torch.linalg.vector_norm(g - d)
                           / torch.linalg.vector_norm(d))
    print(f"  |g_flash - g_dense| / |g_dense| per leaf: "
          f"{ {k: float(f'{v:.3e}') for k, v in rels.items()} }")
    worst = max(rels, key=rels.get)
    check(all(math.isfinite(v) and v < 0.05 for v in rels.values()),
          f"train gradients, flash vs dense: every leaf's relative norm "
          f"difference < 0.05 (largest {rels[worst]:.3e}, {worst})")


def routed_run(torch, cfg, params, tokens):
    """``moe_loss``'s value and gradients on ``tokens`` and
    ``moe_forward``'s logits on ``tokens[:, :-1]`` (the positions the loss
    routes), with the router probabilities every layer's
    ``top_k_dispatch`` routed on in the forward."""
    from pbs_tpu_torch.models import moe as moe_mod
    from pbs_tpu_torch.models.transformer import value_and_grad

    seen, inner = [], moe_mod.top_k_dispatch

    def recording(probs, k, capacity):
        seen.append(probs.detach())
        return inner(probs, k, capacity)

    moe_mod.top_k_dispatch = recording
    try:
        with torch.no_grad():
            logits = moe_mod.moe_forward(cfg, params, tokens[:, :-1])[0]
    finally:
        moe_mod.top_k_dispatch = inner
    (loss, _), grads = value_and_grad(
        lambda p: moe_mod.moe_loss(cfg, p, tokens), params)
    return logits, float(loss), grads, seen


def route_flips(torch, want: list, got: list, k: int) -> list:
    """Per layer, the tokens whose ordered top-k experts differ between
    two runs' router probabilities, each with the reference run's
    smallest gap between adjacent sorted probabilities among its top
    k + 1 (a near-tie shows as a tiny gap)."""
    out = []
    for pw, pg in zip(want, got):
        sw, iw = torch.sort(pw.reshape(-1, pw.shape[-1]), dim=-1,
                            descending=True, stable=True)
        ig = torch.sort(pg.reshape(-1, pg.shape[-1]), dim=-1,
                        descending=True, stable=True)[1]
        flipped = (iw[:, :k] != ig[:, :k]).any(dim=-1).nonzero()[:, 0]
        gaps = (sw[:, :k] - sw[:, 1:k + 1]).min(dim=-1).values
        out.append([(int(t), float(gaps[t])) for t in flipped])
    return out


def check_moe_numerics(torch, gen, master) -> None:
    """fp32 at width: the MoE forward, one batch's loss and every
    gradient leaf through the flash kernels against the dense attention
    path on the same weights (moe-train's capacity routing), with the
    routing decisions that flipped between the two. Without a flip the
    bounds are fp32's; a flip moves its token's output, and must sit at a
    near-tie in the first layer that has one."""
    cfg = moe_config(dtype=torch.float32, attn_impl="pallas")
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                           device="cuda", generator=gen)
    lf, loss_f, g_f, p_f = routed_run(torch, cfg, master, tokens)
    ld, loss_d, g_d, p_d = routed_run(
        torch, dataclasses.replace(cfg, attn_impl="xla"), master, tokens)
    flips = route_flips(torch, p_d, p_f, cfg.top_k)
    n_flips = [len(f) for f in flips]
    first = next((i for i, f in enumerate(flips) if f), None)
    decisions = TRAIN_BATCH * (TRAIN_SEQ - 1) * cfg.n_layers
    print(f"  MoE routing, flash vs dense attention (fp32): flipped "
          f"decisions per layer {n_flips} of {decisions // cfg.n_layers} "
          f"each; at each flip of the first layer that has one, the dense "
          f"run's smallest top-{cfg.top_k + 1} probability gap "
          f"{[f'{g:.2e}' for _, g in flips[first]] if first is not None else []}",
          flush=True)
    if first is not None:
        worst = max(g for _, g in flips[first])
        check(worst < MOE_ROUTE_TIE,
              f"MoE routing: every flip in layer {first} (the first with "
              f"one) at a near-tie, gap {worst:.2e} < {MOE_ROUTE_TIE:g}")
    rels = {name: float(torch.linalg.vector_norm(g - d)
                        / torch.linalg.vector_norm(d))
            for (name, g), (_, d) in zip(named_leaves(g_f),
                                         named_leaves(g_d))}
    worst = max(rels, key=rels.get)
    rel_logits = rel_err(lf, ld)
    rel_loss = abs(loss_f - loss_d) / abs(loss_d)
    print(f"  |g_flash - g_dense| / |g_dense| per leaf: "
          f"{ {k: float(f'{v:.3e}') for k, v in rels.items()} }")
    # fp32 without a flip; with one, the bf16 bounds of the dense phase
    b_logits, b_loss, b_grad = ((1e-3, 1e-4, 1e-3) if first is None
                                else (None, 1e-2, 0.05))
    finite = bool(torch.isfinite(lf).all()) and math.isfinite(loss_f)
    check(finite and tuple(lf.shape) == (TRAIN_BATCH, TRAIN_SEQ - 1,
                                         cfg.vocab)
          and (b_logits is None or rel_logits < b_logits),
          f"MoE logits, flash vs dense attention (fp32): finite, max abs "
          f"diff {max_abs(lf, ld):.3e}, rel {rel_logits:.3e}"
          + (f" < {b_logits:g}" if b_logits else " (a flip: not bounded)"))
    check(rel_loss < b_loss,
          f"MoE loss, flash vs dense (fp32): {loss_f:.6f} vs {loss_d:.6f}, "
          f"rel {rel_loss:.2e} < {b_loss:g}")
    check(all(math.isfinite(v) and v < b_grad for v in rels.values()),
          f"MoE gradients, flash vs dense (fp32): every leaf's relative "
          f"norm difference < {b_grad:g} (largest {rels[worst]:.3e}, "
          f"{worst})")


# -- phase 5 -----------------------------------------------------------------


def sdpa_pair(qt, kt, vt):
    """SDPA's forward on (B, H, S, hd) leaves, for the backward pair's
    yardstick: the flash backend pinned with ``sdpa_kernel`` where it
    takes ``enable_gqa``, else PyTorch's own dispatch. Returns (output,
    which backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return call(), "SDPA flash backend (pinned), enable_gqa"
    except RuntimeError as e:
        why = str(e).splitlines()[0][:160]
        return call(), f"SDPA default dispatch (flash refused: {why})"


def unaligned_copy(torch, t):
    """A contiguous copy of ``t`` 2 bytes past an aligned base: TMA
    cannot address it, so a wrapper takes the CUDA-core route on it."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def time_bwd_kernels(torch, gen, launches, routes, B=TRAIN_BATCH,
                     S=TRAIN_SEQ - 1, path="training", suffix="",
                     simt=True, iters=20) -> list:
    """Kernels 2.2 and 2.3 at a training path's shape (bf16 o and do,
    no lse cotangent, as the model calls them; the rows named with
    ``suffix``), beside (``simt``) their CUDA-core route on the same
    values (through an unaligned copy of q), the row-delta reduction
    they read, the plain backward and one library call, SDPA's backward,
    each of the last two computing dq, dk and dv together."""
    from pbs_tpu_torch.ops import attention as A

    H, Hkv = FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"]
    hd = FLAGSHIP["d_model"] // H
    q = torch.randn(B, S, H, hd, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, S, Hkv, hd, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, S, Hkv, hd, device="cuda", generator=gen).bfloat16()
    o, lse = A.flash_attention_cuda(q, k, v, True)
    do = torch.randn(o.shape, device="cuda", generator=gen).bfloat16()
    row = A._row_delta(o, do, None)
    qu = unaligned_copy(torch, q) if simt else None
    check(A.backward_route(q, k, v, do) == "wgmma"
          and (qu is None or A.backward_route(qu, k, v, do) == "simt"),
          f"backward routes at the {path} path's shape: wgmma"
          + (", and simt for an unaligned copy of q" if simt else ""))
    ref = A.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o,
                                      lse, do.float(), None, True)
    limit = BWD_REL["bfloat16"]
    errs = {}
    for route, qq in (("wgmma", q), ("simt", qu)):
        if qq is None:
            continue
        dq = A.flash_attention_bwd_dq_cuda(qq, k, v, do, lse, row, True)
        dk, dv = A.flash_attention_bwd_dkv_cuda(qq, k, v, do, lse, row, True)
        oks, err = [], []
        for g, want in zip((dq, dk, dv), ref):
            diff = (g.float() - want).abs()
            oks.append(bool((diff <= limit * float(want.abs().max())
                             + BF16_HALF_ULP * want.abs()).all()))
            err.append(float(diff.max()))
        errs[route] = (oks, err)
        check(all(oks), f"flash bwd ({route}) at the {path} path's shape "
                        f"({B}, {S}): dq/dk/dv |g-ref| max {err} <= "
                        f"{limit:g} max|ref| + {BF16_HALF_ULP:g}|ref|")

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out, backend = sdpa_pair(qt, kt, vt)
    dot = do.transpose(1, 2)
    lib_dq = torch.autograd.grad(out, (qt, kt, vt), dot,
                                 retain_graph=True)[0].transpose(1, 2)
    lib_rel = rel_err(lib_dq, ref[0])
    check(lib_rel < 0.05, f"library SDPA backward ({backend}): dq rel err "
                          f"{lib_rel:.2e} < 0.05 against the plain fp32 dq")
    fns = {
        "dq": lambda: A.flash_attention_bwd_dq_cuda(q, k, v, do, lse, row,
                                                     True),
        "dkv": lambda: A.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, row,
                                                       True),
        "row_delta": lambda: A._row_delta(o, do, None),
        "plain": lambda: A.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     None, True),
        # SDPA's pair wanders between calls: more iterations than the rest
        "library": lambda: [torch.autograd.grad(out, (qt, kt, vt), dot,
                                                retain_graph=True)
                            for _ in range(5)],
    }
    if simt:
        fns["dq_simt"] = lambda: A.flash_attention_bwd_dq_cuda(
            qu, k, v, do, lse, row, True)
        fns["dkv_simt"] = lambda: A.flash_attention_bwd_dkv_cuda(
            qu, k, v, do, lse, row, True)
    t = timed_in_turns(torch, fns, iters=iters)
    t["library"] /= 5
    pairs = S * (S + 1) // 2  # causal (query, key) pairs per (b, h)
    shape = (f"q ({B},{S},{H},{hd}) k/v ({B},{S},{Hkv},{hd}) bf16 causal, "
             "bf16 do, no lse cotangent")
    in_bytes = (2 * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)
                + 2 * 4 * B * S * H)  # q, do, k, v; lse, row delta
    oks, err = errs["wgmma"]
    rows = []
    for name, key, flops, out_bytes, e, ok in (
            ("flash_bwd_dq", "dq", 6 * B * H * hd * pairs,
             2 * B * S * H * hd, err[0], oks[0]),
            ("flash_bwd_dkv", "dkv", 8 * B * H * hd * pairs,
             2 * 2 * B * S * Hkv * hd, max(err[1:]), all(oks[1:]))):
        bms, by = bound(flops, in_bytes + out_bytes)
        entry = dict(
            name=name + suffix, route="cuda",
            kernel_route=route_of(routes[name]), **KERNELS[name],
            launches=launches[name], launches_by_route=routes[name],
            path=path, max_abs_err=e, ms=t[key],
            simt_ms=t.get(f"{key}_simt"), row_delta_ms=t["row_delta"],
            plain_ms=t["plain"], library_ms=t["library"],
            library_backend=backend, bound_ms=bms, bound_by=by, ok=ok,
            tolerance=f"|g-ref| <= {limit:g} max|ref| + {BF16_HALF_ULP:g}"
                      "|ref|, ref = plain fp32 backward",
            plain_and_library_compute="dq, dk and dv in one call (pair)",
            shape=shape)
        entry.update(redesign_rates(entry, flops))
        rows.append(entry)
    return rows


def device_self_us(e) -> float:
    """A ``key_averages()`` row's device time of its own, in us."""
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def profile_micro_step(torch, micro_step, state,
                       what: str = "micro-step") -> None:
    """One more training micro-step (or ``what``) under torch.profiler:
    device time by kernel and the device's idle share of the step's wall
    time, each of the port's flash kernels on its own and everything
    else by the telemetry plane's classifier (``classify_kernel``). A
    measurement, not a check: where the profiler records no device time
    it says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pbs_tpu_torch.telemetry.profiler import classify_kernel

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        micro_step(state)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(device_self_us(e) for e in dev)
    if busy <= 0:
        print("  profile: no device time recorded; device time by kernel "
              "not measured", flush=True)
        return
    groups = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
              "compute": 0.0, "memory": 0.0, "collective": 0.0}
    for e in dev:
        key = e.key
        g = next((k for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                  if f"{k}_" in key), None) or classify_kernel(key)
        groups[g] += device_self_us(e)
    print(f"  profiled {what}: {wall_us / 1e3:.2f} ms wall (profiler "
          f"on), {busy / 1e3:.2f} ms device busy, idle share "
          f"{1 - busy / wall_us:.3f}", flush=True)
    print("  device ms by group (the flash kernels, then the rest by "
          "classify_kernel): " + json.dumps(
              {k: round(v / 1e3, 3) for k, v in groups.items()}))
    for e in sorted(dev, key=device_self_us, reverse=True)[:10]:
        print(f"    {device_self_us(e) / 1e3:9.3f} ms  x{e.count:<5} "
              f"{e.key[:90]}")


def time_remat_policies(torch, gen, cfg, params) -> None:
    """One micro-batch's loss and gradients under each remat setting:
    host wall time closed by a synchronise, and peak device memory. A
    measurement of where the training step's time goes, not a check."""
    from pbs_tpu_torch.models.transformer import loss_and_grads

    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                           device="cuda", generator=gen)
    for remat, policy in ((False, "dots"), (True, "dots"), (True, "full")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        loss_and_grads(c, params, tokens)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        for _ in range(2):
            loss_and_grads(c, params, tokens)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) / 2 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  loss+grads, remat={remat} policy={policy if remat else '-'}"
              f": {ms:.2f} ms per micro-batch (host clock), peak "
              f"{peak:.2f} GiB allocated", flush=True)


def route_of(counts: dict) -> str:
    """The route(s) a main path's launches took, from a wrapper's
    ``launches_by_route``: "wgmma", "simt", or both joined by "+"."""
    return "+".join(r for r, n in counts.items() if n) or "none"


def redesign_rates(row: dict, flops: float) -> dict:
    """Achieved TFLOP/s (useful work over kernel time) and the fraction
    of the bound the kernel reaches (bound_ms / ms)."""
    return dict(tflops=flops / (row["ms"] * 1e-3) / 1e12,
                bound_fraction=row["bound_ms"] / row["ms"])


def time_flash_fwd(torch, gen, B, S, launches, routes, path,
                   name=None, iters=10) -> dict:
    """Kernel 2.1 at one main path's shape (bf16, causal, bf16 o), held
    against its plain version, timed beside it and beside SDPA."""
    import torch.nn.functional as F

    from pbs_tpu_torch.ops.attention import (flash_attention_cuda,
                                             flash_attention_plain)

    H, Hkv = FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"]
    hd = FLAGSHIP["d_model"] // H
    q = torch.randn(B, S, H, hd, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, S, Hkv, hd, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, S, Hkv, hd, device="cuda", generator=gen).bfloat16()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ok, err, err_l, limit = flash_against_plain(torch, q, k, v, True)
    check(ok, f"flash at the {path} path's shape: |o-ref| max {err:.2e} <= "
              f"{limit}, lse {err_l:.2e} <= {FLASH_ATOL:g}")
    t = timed_in_turns(torch, {
        "ms": lambda: flash_attention_cuda(q, k, v, True),
        "plain_ms": lambda: flash_attention_plain(q, k, v, True),
        "library_ms": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
    }, iters=iters)
    pairs = S * (S + 1) // 2  # causal (query, key) pairs per (b, h)
    flops = 4 * B * H * hd * pairs
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * Hkv * hd) + 4 * B * S * H
    bms, by = bound(flops, nbytes)
    row = dict(name=name or ("flash_fwd" if path == "serving"
                             else "flash_fwd_training_shape"), route="cuda",
               kernel_route=route_of(routes), **KERNELS["flash_fwd"],
               launches=launches, launches_by_route=routes, path=path,
               max_abs_err=err, **t, bound_ms=bms, bound_by=by, ok=ok,
               tolerance=f"|o-ref| <= {limit}, ref = plain fp32 o",
               shape=f"q ({B},{S},{H},{hd}) k/v ({B},{S},{Hkv},{hd}) "
                     "bf16 causal")
    row.update(redesign_rates(row, flops))
    return row


def time_kernels(torch, gen, launches, routes, train_launches,
                 train_routes, long_launches) -> list:
    from pbs_tpu_torch.ops.matmul import (instrumented_matmul_cuda,
                                          instrumented_matmul_plain)

    rows = [time_flash_fwd(torch, gen, SCORE_BATCH, SCORE_SEQ,
                           launches["flash_fwd"], routes["flash_fwd"],
                           "serving"),
            time_flash_fwd(torch, gen, TRAIN_BATCH, TRAIN_SEQ - 1,
                           train_launches["flash_fwd"],
                           train_routes["flash_fwd"], "training")]
    rows += time_bwd_kernels(torch, gen, train_launches, train_routes)
    # the long-context path's shapes (phase 3b (b)'s flash column)
    for (B, S), (l_launches, l_routes) in long_launches.items():
        suffix = f"_longctx_s{S}"
        rows.append(time_flash_fwd(torch, gen, B, S, l_launches["flash_fwd"],
                                   l_routes["flash_fwd"], "long-context",
                                   name="flash_fwd" + suffix, iters=5))
        rows += time_bwd_kernels(torch, gen, l_launches, l_routes, B, S,
                                 "long-context", suffix, simt=False,
                                 iters=5)

    a, b = mm_operands(torch, gen)
    blk = MM_BLOCK
    out, raw = instrumented_matmul_cuda(a, b, blk, blk, blk)
    ref, ref_raw = instrumented_matmul_plain(a, b, blk, blk, blk)
    err, rel = max_abs(out, ref), rel_err(out, ref)
    mm_ok = raw.tolist() == ref_raw.tolist() and rel < 1e-3
    check(mm_ok, f"matmul at the main path's shape: stats {raw.tolist()} "
                 f"== plain, rel err {rel:.2e} < 1e-3")
    fns = {
        "ms": lambda: instrumented_matmul_cuda(a, b, blk, blk, blk),
        "plain_ms": lambda: instrumented_matmul_plain(a, b, blk, blk, blk),
    }
    library = mm_library_call(torch, a, b, ref)
    if library is not None:
        fns["library_ms"] = library
    t = {"library_ms": None, **timed_in_turns(torch, fns, iters=5)}
    flops = 2 * MM_N ** 3
    nbytes = 2 * 2 * MM_N * MM_N + 4 * MM_N * MM_N + 16
    bms, by = bound(flops, nbytes)
    row = dict(name="instrumented_matmul", route="cuda",
               kernel_route=route_of(routes["instrumented_matmul"]),
               **KERNELS["instrumented_matmul"],
               launches=launches["instrumented_matmul"],
               launches_by_route=routes["instrumented_matmul"], path="serving",
               max_abs_err=err, **t, bound_ms=bms, bound_by=by,
               ok=mm_ok, tolerance="stats equal, rel err < 1e-3",
               shape=f"{MM_N}^3 bf16 in, fp32 out, blocks {blk}")
    row.update(redesign_rates(row, flops))
    rows.append(row)
    for r in rows:
        rates = (f", {r['tflops']:.1f} TFLOP/s, {r['bound_fraction']:.3f} "
                 f"of the bound" if "tflops" in r else "")
        if r.get("simt_ms") is not None:
            rates += f"; CUDA-core route {r['simt_ms']:.4f} ms"
        if "row_delta_ms" in r:
            rates += (f"; row delta {r['row_delta_ms']:.4f} ms; library: "
                      f"{r['library_backend']}")
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} "
              f"by {r['bound_by']}{rates}) at {r['shape']}", flush=True)
    return rows


def mm_library_call(torch, a, b, ref):
    """The one PyTorch call that writes the fp32 product of bf16
    operands, ``torch.mm(..., out_dtype=torch.float32)``, or None where
    this torch build lacks it (``torch.matmul`` writes a bf16 result, a
    different function)."""
    try:
        out = torch.mm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        print(f"  torch.mm(out_dtype=float32) unavailable, library_ms "
              f"null: {str(e).splitlines()[0]}", flush=True)
        return None
    rel = rel_err(out, ref)
    check(out.dtype == torch.float32 and rel < 1e-3,
          f"library torch.mm(out_dtype=float32): fp32 out, rel err "
          f"{rel:.2e} < 1e-3")
    return lambda: torch.mm(a, b, out_dtype=torch.float32)


_TEMPLATE_ARG = re.compile(r"13__nv_bfloat16|S\d*_|Li(\d+)E|f")


def ptxas_report(log: str) -> list[str]:
    """nvcc's -Xptxas -v output cut to one line per kernel: its name and
    template arguments, registers, static shared memory and spills (the
    wgmma kernels' shared memory is dynamic, sized in their sources)."""
    lines, name, spill = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"\d\d?([a-z][a-z_]*_kernel)(?:I(\w*?E)E)?", ln)
            if m is None:
                name = ln.strip()
                continue
            args: list[str] = []
            for t in _TEMPLATE_ARG.finditer(m.group(2) or ""):
                # a substitution (S_) repeats the type before it
                args.append("bf16" if t.group(0)[0] == "1" else "fp32"
                            if t.group(0) == "f" else t.group(1)
                            or args[-1])
            name = f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            lines.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return lines


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return smi.splitlines()[0]


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-out", default=None,
                    help="also write one profiled quantum's trimmed Chrome "
                         "trace (kernels 2.1-2.4 and a tanh chain) here")
    ap.add_argument("--baseline-out", default=None,
                    help="also write phase 3f(d)'s perf baseline (the four "
                         "maps, stamped) here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from pbs_tpu_torch.models import (TransformerConfig, cast_params,
                                      init_params)
    from pbs_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    phase("1 build")
    t0 = time.monotonic()
    # The native runtime (g++) builds beside the kernels (one nvcc each).
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        native_built = pool.submit(native_build)
        built = cuda_build.build()
        native_built = native_built.result()
    for r in built.values():
        print(f"  {r.name}: {r.seconds:.1f} s -> {r.path.name}")
        for ln in ptxas_report(r.log):
            print(f"    {ln}")
    for kind, (secs, path, err) in native_built.items():
        print(f"  native {kind}: {secs:.1f} s -> "
              f"{path.name if path is not None else err}")
    print(f"  build wall {time.monotonic() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    phase("2 kernels against their plain versions")
    check_kernels(torch, gen)

    phase("3 main path: Partition + FeedbackPolicy + CudaBackend")
    cfg = TransformerConfig(**FLAGSHIP, dtype=torch.bfloat16)
    # cast once at load: the values of wload's per-call cast
    params = cast_params(init_params(cfg, gen, device="cuda"), cfg.dtype)
    print(f"  flagship: {cfg.num_params() / 1e6:.0f}M params, bf16, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    launches, routes, serve_ms_per_token = run_main_path(torch, gen, cfg,
                                                         params)

    phase("3t train: a micro-stepped training Job beside the serving tenant")
    (train_launches, train_routes, train_cfg, train_params, micro_step,
     train_state) = run_train_path(torch, gen, cfg, params)

    phase("3m measured telemetry: torch.profiler samples steer the slices")
    m_launches, m_routes = run_measured_path(torch, gen, cfg, params, built)
    if args.trace_out:
        write_trace_fixture(torch, gen, args.trace_out)

    phase("3s serving engine: continuous batching as a tenant, fp32 "
          "exactness, speculative and int8 serving")
    e_launches, e_routes, a_tokens = run_engine_path(
        torch, gen, cfg, params, serve_ms_per_token, card_line())

    phase("3g gateway: the engine behind the port's gateway as a scheduled "
          "tenant, co-located and alone")
    g_launches, g_routes = run_gateway_path(torch, gen, cfg, params,
                                            a_tokens, card_line())

    phase("3p memory: HBM admission, shared weights, an image boot, paging "
          "under pressure, an async checkpoint, the loader")
    p_launches, p_routes = run_paging_path(torch, gen, card_line())

    phase("3e MoE: a training tenant booted from a \"moe\" image beside the "
          "dropless MoE engine; fp32 exactness and speculation")
    (moe_launches, moe_routes, moe_step, moe_state,
     moe_master) = run_moe_path(torch, gen, serve_ms_per_token, card_line())

    phase("3c control plane: credit2, SEDF and ARINC 653 over the tenants, "
          "the ATC policy and live knob pushes, xsm, hooks, the watchdog, "
          "crash dumps")
    c_launches, c_routes = run_control_path(torch, gen, cfg, params,
                                            card_line())

    phase("3r record, replay and tune: a live run recorded through the "
          "host counter plane, replayed offline under three schedulers, a "
          "tune search on its numbers, the winner armed")
    r_launches, r_routes, recorded = run_record_path(torch, gen, cfg, params,
                                                     card_line())

    phase("3n native runtime under the main path: the C ledger, rings and "
          "histograms, a monitor process over the ledger file and a "
          "doorbell, tier costs, the native sim core, the native gather")
    n_launches, n_routes, n_costs = run_native_path(
        torch, gen, cfg, params, card_line(), native_built, recorded)

    phase("3j durability and federation: a journaled gateway killed and "
          "recovered from its journal, a federation through a member "
          "death, a drain, a rejoin, a canary push and a crash, the chaos "
          "harnesses")
    j_launches, j_routes = run_journal_path(torch, card_line())

    phase("3d cluster control plane: two agents and a controller over RPC, "
          "the flagship image placed, live-migrated, paged and replicated "
          "with Remus through a holder's death, the store, the process "
          "federation and the agent chaos harness")
    d_launches, d_routes = run_cluster_path(torch, gen, card_line())

    phase("3a closed tuning loop: shadow capture, shadow search and an "
          "SLO-guarded canary over engine members, the loop's decisions "
          "steering a card partition, the autopilot chaos gate, the "
          "scenario frontier")
    a_launches, a_routes = run_autopilot_path(torch, gen, cfg, params,
                                              a_tokens, card_line())

    phase("3k static checker: the port's named locks under lockdep through "
          "one agent on the card, pbst-torch check over the port's tree "
          "with the live lock-order graph, and a reversed edge it must "
          "catch")
    k_launches, k_routes = run_check_path(torch, gen, cfg, params,
                                          card_line())

    phase("3f foreign tenants and their observers: three callables that "
          "follow no protocol adopted through Job.foreign with a counted "
          "cost harvest, profiled and monitored from a torch-free process, "
          "the obs dump into the lock-order check, the host's costs")
    f_launches, f_routes = run_observer_path(
        torch, gen, cfg, params, card_line(), n_costs, args.baseline_out)

    phase("3x parallel schedules: the ring, Ulysses, tp, the pipeline and "
          "expert parallelism on two rank processes sharing the card, "
          "their exchanges staged through the host; a one-rank NCCL world")
    x_launches, x_routes = run_parallel_path(torch, card_line())

    phase("3v serving tier: rule-partitioned and disaggregated serve "
          "backends behind the gateway, tensor-parallel engines on two rank "
          "processes sharing the card, the serve command")
    v_launches, v_routes = run_serve_path(torch, cfg, params, a_tokens,
                                          card_line())

    phase("3b drivers: entry(), the long-context training path through the "
          "flash kernels at 4K and 8K, bench_serving's rows, "
          "dryrun_multichip(8) on the host's CPU, the three walkthroughs, "
          "the headline bench's twin")
    b_launches, b_routes, long_launches = run_drivers_path(torch,
                                                           card_line())

    phase("4 numerics at width")
    check_numerics(torch, gen, cfg, params)
    del params
    check_train_numerics(torch, gen, train_cfg, train_params)
    check_moe_numerics(torch, gen, moe_master)
    del moe_master

    phase("5 times at the main paths' shapes")
    rows = time_kernels(torch, gen, launches, routes, train_launches,
                        train_routes, long_launches)
    for r in rows:  # phase 3m's launches of the same kernel
        kernel = next(k for k in KERNELS
                      if r["name"] == k or r["name"].startswith(k + "_"))
        r["measured_path_launches"] = m_launches[kernel]
        r["measured_path_launches_by_route"] = m_routes[kernel]
        # phase 3s's run: 2.1 (score) and 2.4 (mm) beside the engine
        r["engine_path_launches"] = e_launches[kernel]
        r["engine_path_launches_by_route"] = e_routes[kernel]
        # phase 3g(a)'s run: the same beside the gateway's Job
        r["gateway_path_launches"] = g_launches[kernel]
        r["gateway_path_launches_by_route"] = g_routes[kernel]
        # phase 3p's run: scorers, train-a and train-b
        r["memory_path_launches"] = p_launches[kernel]
        r["memory_path_launches_by_route"] = p_routes[kernel]
        # phase 3e(a)'s run: moe-train beside moe-serve
        r["moe_path_launches"] = moe_launches[kernel]
        r["moe_path_launches_by_route"] = moe_routes[kernel]
        # phase 3c's runs (a)-(c): credit2, SEDF and ARINC 653
        r["control_path_launches"] = c_launches[kernel]
        r["control_path_launches_by_route"] = c_routes[kernel]
        # phase 3r's live runs (a) and (d): recorded under HwCounterSource
        r["record_path_launches"] = r_launches[kernel]
        r["record_path_launches_by_route"] = r_routes[kernel]
        # phase 3n(b)'s run: 3c's tenants on the native runtime tiers
        r["native_path_launches"] = n_launches[kernel]
        r["native_path_launches_by_route"] = n_routes[kernel]
        # phase 3j (a)'s crashed run and (b)'s federation: the engines
        # alone, which launch none of the four
        r["journal_path_launches"] = j_launches[kernel]
        r["journal_path_launches_by_route"] = j_routes[kernel]
        # phase 3d (a)-(c): train through a migration and a failover
        # (2.1-2.3), mm before and after it (2.4)
        r["cluster_path_launches"] = d_launches[kernel]
        r["cluster_path_launches_by_route"] = d_routes[kernel]
        # phase 3a (b): score (2.1) and mm (2.4) steered by the loop
        r["autopilot_path_launches"] = a_launches[kernel]
        r["autopilot_path_launches_by_route"] = a_routes[kernel]
        # phase 3k (a): score (2.1) and mm (2.4) under lockdep
        r["check_path_launches"] = k_launches[kernel]
        r["check_path_launches_by_route"] = k_routes[kernel]
        # phase 3f (a): fscore (2.1), its counted invocation included
        r["observer_path_launches"] = f_launches[kernel]
        r["observer_path_launches_by_route"] = f_routes[kernel]
        # phase 3x (b): the five schedules' two steps on both ranks
        r["parallel_path_launches"] = x_launches[kernel]
        r["parallel_path_launches_by_route"] = x_routes[kernel]
        # phase 3v (a)-(c): the serve backends and both ranks' tp
        # engines, which launch none of the four
        r["serve_path_launches"] = v_launches[kernel]
        r["serve_path_launches_by_route"] = v_routes[kernel]
        # phase 3b (b) and (f2): the long-context flash column's steps
        # and the headline's worker body with attn "pallas"
        r["drivers_path_launches"] = b_launches[kernel]
        r["drivers_path_launches_by_route"] = b_routes[kernel]
    profile_micro_step(torch, micro_step, train_state)
    del micro_step, train_state
    profile_micro_step(torch, moe_step, moe_state, what="MoE training step")
    del moe_step, moe_state
    time_remat_policies(torch, gen, train_cfg, train_params)

    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
