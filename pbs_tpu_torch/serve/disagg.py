"""Prefill/decode disaggregation behind one gateway backend.

The port of ``pbs_tpu.serve.disagg``. The serving literature's split —
prefill is compute-bound and bursty, decode is latency-bound and steady
— maps here onto two pools sharing one rule-partitioned param tree: a
prefill pool that only ingests prompts (``ingest_slot_prompt`` on its
own slot slab), and a decode pool that is a stock
:class:`~pbs_tpu_torch.models.serving.ContinuousBatcher` which NEVER
prefills. The KV handoff between them rides the engine's exact-prompt
prefix-cache install path: a prefilled request's prompt window (KV
slabs + last-position logits) is published into the decode engine's
prefix cache and then submitted, so admission installs the window with
zero prefill compute — the handoff is the cache fill. The decode
engine's ``prefill_count`` is therefore the disaggregation violation
counter: any nonzero value means a handoff window was lost and the
decode pool did prefill work (tests pin it to zero).

Span semantics: one stitched chain per request — the gateway's
DISPATCH, an EXEC when the prompt enters the prefill pool, then
SPAN_HANDOFF(prefill -> decode) + an internal re-DISPATCH via the
gateway's ``handoff_hook`` seam, then decode-side EXECs and the
ordinary COMPLETE. ``SpanAssembler`` already accepts HANDOFF from
inflight (the federation stitch), so a disaggregated timeline
validates under the same continuity invariant as every other chain.

Per-tick budgets come from the declared ``serve.disagg.*`` knobs:
``pool_split_ratio`` sizes the pools, ``prefill_chunk_tokens`` bounds
prompt tokens ingested per gateway tick, ``kv_handoff_batch`` bounds
handoffs per tick — all canary-able by the autopilot.

Where the port parts from the reference: the prefill pool's slab is
updated in place, so a handed-off window (and its logits) is a COPY:
a view would be overwritten by the next prompt ingested into the same
lane while the window still waits in the handoff queue (backpressure
holds it there). ``device=``, ``params=None`` and an MoE tree are as
for :class:`~pbs_tpu_torch.serve.backend.ShardedServeBackend`; under
``tp > 1`` each ``poll`` first checks that every rank holds the same
pools at the same tick.
"""

from __future__ import annotations

import zlib
from collections import deque

import numpy as np

from pbs_tpu_torch import knobs
from pbs_tpu_torch.gateway.backends import Backend
from pbs_tpu_torch.gateway.fairqueue import Request
from pbs_tpu_torch.serve.backend import _bring_up, mesh_shape, synth_payload

POOL_SPLIT_RATIO = knobs.default("serve.disagg.pool_split_ratio")
PREFILL_CHUNK_TOKENS = knobs.default("serve.disagg.prefill_chunk_tokens")
KV_HANDOFF_BATCH = knobs.default("serve.disagg.kv_handoff_batch")


class PrefillPool:
    """The ingest-only pool: ``n_lanes`` slots of a private KV slab,
    the shared ``ingest_slot_prompt``, no decode. ``prefill()`` returns
    the request's prompt-window KV + logits as copies — the handoff
    payload. ``params`` are the tree the decode engine holds (this
    rank's blocks under a mesh); ``device`` defaults to the mesh's, and
    without a mesh None means the card."""

    def __init__(self, cfg, params, *, n_lanes: int, bucket: int,
                 max_len: int, mesh=None, mlp_fn=None, device=None):
        from pbs_tpu_torch.models.serving import (
            _engine_device, _shard_slot_cache, init_slot_cache,
        )
        from pbs_tpu_torch.parallel.sharding import ServingSeams

        self.cfg = cfg
        self.n_lanes = int(n_lanes)
        self.bucket = int(bucket)
        self.mlp_fn = mlp_fn
        self.device = _engine_device(
            mesh.device if mesh is not None and device is None else device)
        self.cache = init_slot_cache(cfg, self.n_lanes, int(max_len),
                                     self.device)
        if mesh is not None:
            self.cache = _shard_slot_cache(self.cache, mesh)
        self._tp = ServingSeams(mesh)
        self._next_lane = 0
        self.prompts_ingested = 0
        self.tokens_ingested = 0
        # First launches at construction, not in the first tenant's
        # TTFT (the engines' warm-up rule); then a fresh slab.
        self._ingest(params, 0, np.zeros(self.bucket, np.int32), 1)
        for t in self.cache.values():
            t.zero_()

    def _ingest(self, params, lane: int, padded: np.ndarray, plen: int):
        import torch

        from pbs_tpu_torch.models.serving import ingest_slot_prompt

        prompt = torch.tensor(padded, dtype=torch.int32, device=self.device)
        last_logits, self.cache, _extra = ingest_slot_prompt(
            self.cfg, params, self.cache, lane, prompt, plen,
            mlp_fn=self.mlp_fn, tp=self._tp)
        return last_logits

    def prefill(self, params, prompt: np.ndarray
                ) -> tuple[object, object, object]:
        """Ingest one prompt; returns (last_logits, kwin, vwin) where
        the windows are (L, 1, bucket, nkv, hd) device copies — the
        shape the decode engine's install takes."""
        plen = len(prompt)
        padded = np.zeros(self.bucket, np.int32)
        padded[:plen] = prompt
        lane = self._next_lane
        self._next_lane = (lane + 1) % self.n_lanes
        last_logits = self._ingest(params, lane, padded, plen)
        self.prompts_ingested += 1
        self.tokens_ingested += plen
        kwin = self.cache["k"][:, lane:lane + 1, :self.bucket].clone()
        vwin = self.cache["v"][:, lane:lane + 1, :self.bucket].clone()
        return last_logits.clone(), kwin, vwin


class DisaggServeBackend(Backend):
    """Two pools, one backend, one stitched span chain per request."""

    def __init__(self, name: str, cfg, params=None, *, tp: int = 1,
                 dp: int = 1, n_slots: int | None = None,
                 split: float | None = None,
                 prompt_bucket: int = 16, max_len: int | None = None,
                 seed: int = 0, clock: str = "wall",
                 chunk_tokens: int | None = None,
                 handoff_batch: int | None = None, device=None):
        from pbs_tpu_torch.models.serving import ContinuousBatcher
        from pbs_tpu_torch.parallel.sharding import ServingSeams

        if clock not in ("wall", "virtual"):
            raise ValueError(f"clock must be 'wall' or 'virtual', "
                             f"got {clock!r}")
        self.name = name
        self.cfg = cfg
        self.mesh, params, _gather, kw = _bring_up(cfg, params, tp, dp,
                                                   seed, device)
        self._virtual = clock == "virtual"
        self._now_ns = 0

        total = int(n_slots if n_slots is not None
                    else knobs.default("serve.backend.decode_slots"))
        split = float(split if split is not None else POOL_SPLIT_RATIO)
        n_prefill = max(1, min(total - 1, round(total * split))) \
            if total > 1 else 1
        n_decode = max(1, total - n_prefill)
        self.chunk_tokens = int(chunk_tokens if chunk_tokens is not None
                                else PREFILL_CHUNK_TOKENS)
        self.handoff_batch = int(handoff_batch if handoff_batch
                                 is not None else KV_HANDOFF_BATCH)
        max_len = int(max_len or cfg.max_seq)

        # The decode pool never prefills: every admission must hit the
        # prefix cache (the handoff window). Size the cache so a full
        # handoff pipeline cannot evict a window before its admission.
        self.engine = ContinuousBatcher(
            cfg, params, n_slots=n_decode, prompt_bucket=prompt_bucket,
            max_len=max_len, seed=seed, mesh=self.mesh,
            prefix_cache_size=max(16, 4 * n_decode
                                  + 2 * self.handoff_batch),
            clock=(lambda: self._now_ns * 1e-9) if self._virtual
            else None, **kw)
        # The prefill pool ingests with the decode engine's blocks.
        self.prefill_pool = PrefillPool(
            cfg, self.engine.params, n_lanes=n_prefill,
            bucket=prompt_bucket, max_len=max_len, mesh=self.mesh,
            mlp_fn=kw.get("mlp_fn"))
        self.capacity = total
        self._ingress: deque[Request] = deque()
        self._handoff: deque[tuple] = deque()
        self._by_engine_rid: dict[int, Request] = {}
        self.handoffs = 0
        self.synth_dispatches = 0
        self.bypass_submits = 0
        self._submitting = False
        self._tp = ServingSeams(self.mesh)
        self._polls = 0
        self._dispatch_digest = 0
        prev_hook = getattr(self.engine, "submit_hook", None)

        def _hook(rid: int, prompt_len: int, max_new: int) -> None:
            if not self._submitting:
                self.bypass_submits += 1
            if prev_hook is not None:
                prev_hook(rid, prompt_len, max_new)

        self.engine.submit_hook = _hook

    # -- gateway surface ---------------------------------------------------

    def _observe(self, now_ns: int) -> None:
        if self._virtual and now_ns > self._now_ns:
            self._now_ns = int(now_ns)

    def alive(self) -> bool:
        return True

    def depth(self) -> int:
        return (len(self._ingress) + len(self._handoff)
                + len(self.engine.queue) + int(self.engine.active.sum()))

    def dispatch_request(self, req: Request, now_ns: int) -> None:
        self._observe(now_ns)
        if "prompt" not in req.payload:
            prompt, max_new = synth_payload(
                req, self.engine.bucket, self.engine.max_len,
                self.cfg.vocab)
            req.payload = dict(req.payload,
                               prompt=prompt, max_new=max_new)
            self.synth_dispatches += 1
        self._dispatch_digest = zlib.crc32(
            np.asarray(req.payload["prompt"], np.int32).tobytes()
            + np.int32(req.payload["max_new"]).tobytes(),
            self._dispatch_digest)
        self._ingress.append(req)

    def _run_prefills(self, now_ns: int) -> None:
        budget = self.chunk_tokens
        lanes = self.prefill_pool.n_lanes
        while self._ingress and lanes > 0:
            req = self._ingress[0]
            prompt = np.asarray(req.payload["prompt"], np.int32
                                ).reshape(-1)
            # At-least-one per tick: a prompt longer than the whole
            # chunk budget must still make progress or it deadlocks.
            if len(prompt) > budget and budget < self.chunk_tokens:
                break
            self._ingress.popleft()
            logits, kwin, vwin = self.prefill_pool.prefill(
                self.engine.params, prompt)
            if self.exec_hook is not None:  # execution begins: prefill
                self.exec_hook(req, now_ns)
            self._handoff.append(
                (req, prompt, int(req.payload["max_new"]),
                 logits, kwin, vwin))
            budget -= len(prompt)
            lanes -= 1
            if budget <= 0:
                break

    def _run_handoffs(self, now_ns: int) -> None:
        moved = 0
        # Backpressure: never queue more than one engine-load of
        # handed-off work — keeps every published window alive in the
        # prefix cache until its admission.
        while (self._handoff and moved < self.handoff_batch
               and len(self.engine.queue) < self.engine.n_slots):
            req, prompt, max_new, logits, kwin, vwin = \
                self._handoff.popleft()
            self.engine._prefix_cache[prompt.tobytes()] = {
                "k": kwin, "v": vwin, "logits": logits,
                "plen": len(prompt),
            }
            while (len(self.engine._prefix_cache)
                   > self.engine.prefix_cache_size):
                self.engine._prefix_cache.popitem(last=False)
            self._submitting = True
            try:
                erid = self.engine.submit(prompt, max_new)
            finally:
                self._submitting = False
            self._by_engine_rid[erid] = req
            self.handoffs += 1
            moved += 1
            if self.handoff_hook is not None:
                self.handoff_hook(req, now_ns,
                                  f"{self.name}/prefill",
                                  f"{self.name}/decode")

    def poll(self, now_ns: int) -> list[tuple[Request, dict]]:
        self._observe(now_ns)
        eng = self.engine
        self._tp.agree([self._polls, self._dispatch_digest,
                        len(self._ingress), len(self._handoff), eng.steps,
                        len(eng.queue), int(eng.active.sum())],
                       f"disagg tick {self._polls}")
        self._polls += 1
        self._run_prefills(now_ns)
        self._run_handoffs(now_ns)
        if not self.engine.has_work():
            return []
        inflight_before = {
            rid for rid in self.engine.slot_req if rid is not None}
        comps = self.engine.step()
        if self.exec_hook is not None:
            for erid in sorted(
                    rid for rid in self.engine.slot_req
                    if rid is not None and rid not in inflight_before):
                req = self._by_engine_rid.get(erid)
                if req is not None:  # decode-slot entry
                    self.exec_hook(req, now_ns)
        out: list[tuple[Request, dict]] = []
        for comp in comps:
            req = self._by_engine_rid.pop(comp.request_id, None)
            if req is None:
                continue  # bypass submission's completion: not ours
            if self.exec_hook is not None:  # retirement
                self.exec_hook(req, now_ns)
            out.append((req, {
                "service_ns": int(comp.latency_s * 1e9),
                "ttft_ns": int(comp.ttft_s * 1e9),
                "tokens": len(comp.tokens),
                "backend": self.name,
                "stage": "disagg",
            }))
        return out

    def drain(self) -> list[Request]:
        """Backend-loss path: hand back everything not yet holding a
        decode slot — ingress, prefilled-but-not-handed-off, and
        engine-queued requests (slot holders complete via poll, the
        ``BatcherBackend`` drain contract)."""
        out = list(self._ingress)
        self._ingress.clear()
        out.extend(req for req, *_ in self._handoff)
        self._handoff.clear()
        kept = deque()
        for item in self.engine.queue:
            req = self._by_engine_rid.pop(item[0], None)
            if req is not None:
                out.append(req)
            else:
                kept.append(item)
        self.engine.queue = kept
        return out

    # -- observability ----------------------------------------------------

    def stats(self) -> dict:
        eng = self.engine.stats()
        return {
            **eng,
            "backend": self.name,
            "mesh": mesh_shape(self.mesh),
            "pools": {"prefill_lanes": self.prefill_pool.n_lanes,
                      "decode_slots": self.engine.n_slots},
            "prompts_prefilled": self.prefill_pool.prompts_ingested,
            "prefill_tokens": self.prefill_pool.tokens_ingested,
            "handoffs": self.handoffs,
            # THE disaggregation invariant: the decode pool never
            # prefills — every admission hits a handed-off window.
            "decode_pool_prefills": self.engine.prefill_count,
            "synth_dispatches": self.synth_dispatches,
            "bypass_submits": self.bypass_submits,
        }
