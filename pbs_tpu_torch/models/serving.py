"""Continuous batching: the slot-based serving engine.

The port of ``pbs_tpu.models.serving``. The lockstep batch-inference
tenant (``make_serve_step``) generates request batches in lockstep — a
late request waits for the whole previous batch. This module is the
serving engine modern LLM systems use: **continuous batching** — a
fixed pool of decode slots advancing one token per tick for ALL active
requests, with new requests admitted into free slots at tick boundaries
and finished ones retired immediately.

The design is the reference's:

- **Static shapes**: ``n_slots`` decode lanes, one shared KV slab
  ``(L, n_slots, T, nkv, hd)``, prompts padded to a static bucket.
  Admission and retirement change DATA (per-slot cursors and masks),
  never shapes, so the decode tick is the same launch sequence whatever
  the traffic.
- **Per-slot cursors**: every slot carries its own position in a
  device ``int32`` tensor; rope tables are gathered per row, cache
  writes land per row, and the causal mask compares against each row's
  own position.
- **Inactive lanes ride along**: an empty slot still computes (masked
  to self-attention on garbage it never emits).
- **Host admission between ticks**: ``step()`` is a scheduler-quantum-
  sized unit (one token across slots), so a serving Job interleaves
  with other tenants at token granularity.

Where PyTorch parts from JAX: the KV slabs and cursors are updated in
place (so a prefix-cache entry is a copy of its window, not a view of
the slab), the two "programs" are eager functions, and construction
runs each once and then resets the device state, so first launches do
not land in the first request's time to first token. The one host read
per decode tick is the sampled tokens. Sampling draws from a
``torch.Generator`` seeded from ``seed``: greedy output is token-exact
against the reference; sampled output follows the same distribution,
not JAX's stream. The attention is the reference's dense masked einsum
(no kernel on this path). Tensor-parallel serving (``mesh=``) waits for
``parallel/`` (ROADMAP queue 1, items 7-8); the ``mlp_fn`` seam is
ported, MoE serving through it waits for ``models/moe.py`` (item 6).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from collections import OrderedDict, deque
from typing import Any

import numpy as np
import torch

from pbs_tpu_torch.models.generate import _sample
from pbs_tpu_torch.models.quant import embed_rows, wload
from pbs_tpu_torch.models.transformer import (
    TransformerConfig,
    layer_params,
    resolve_device,
    rms_norm,
    rope_tables,
    tree_leaves,
)
from pbs_tpu_torch.utils.stats import nearest_rank

_MESH_MISSING = ("tensor-parallel serving (mesh=) is not ported yet: it "
                 "needs parallel/ (ROADMAP queue 1, items 7-8)")


def _rope_rows(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Per-row rope: x (B, S, H, hd); cos/sin (B, S, half)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def init_slot_cache(cfg: TransformerConfig, n_slots: int, max_len: int,
                    device: Any = None) -> dict:
    """Zeroed KV slabs (L, n_slots, max_len, n_kv_heads, head_dim) and
    per-slot cursors, on ``device`` (None means the card, and raises
    without one)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "pos": torch.zeros((n_slots,), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def _slot_forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
                  cache: dict, row_pos: torch.Tensor,
                  mlp_fn=None) -> tuple[torch.Tensor, dict, Any]:
    """Forward (B, S) tokens where row b sits at absolute position
    ``row_pos[b]`` (per-row cursors). Writes K/V at ``row_pos[b] + s``
    into the cache slabs, in place; row b's query s attends cols <=
    row_pos[b] + s. Returns (logits (B, S, vocab) fp32, the cache, the
    FFN's auxiliary scalar summed over layers).

    The edges are the reference's: a row's write start is clamped to
    ``T - S`` (``dynamic_update_slice`` clamps so) and its rope and mask
    positions separately to ``T - 1``. No host read happens here.

    ``mlp_fn(lp, h) -> (y, extra)`` swaps the FFN block; ``extra`` is
    summed over layers (callers divide by ``cfg.n_layers``). Without
    ``mlp_fn`` the sum is the Python float 0.0, so reading it costs no
    device synchronise."""
    B, S = tokens.shape
    T = cache["k"].shape[2]
    dt = cfg.dtype
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    group = nh // nkv
    dev = tokens.device

    x = embed_rows(params["embed"], tokens, dt)
    cos_full, sin_full = rope_tables(cfg, T, device=dev)
    offs = torch.arange(S, dtype=torch.int32, device=dev)
    # absolute position of every (row, s) element: (B, S)
    abs_pos = (row_pos[:, None] + offs[None, :]).clamp(max=T - 1)
    cos = cos_full[abs_pos.long()]  # (B, S, half)
    sin = sin_full[abs_pos.long()]
    # Each row writes S CONTIGUOUS entries from its own (clamped) start.
    rows = torch.arange(B, device=dev)[:, None]
    cols = (row_pos.clamp(0, T - S)[:, None] + offs[None, :]).long()
    # per-row causal horizon: row b's query s sees cols <= abs_pos
    reach = (torch.arange(T, device=dev)[None, None, :]
             <= abs_pos[:, :, None])  # (B, S, T)
    hidden = ~reach[:, None, None, :, :]

    extra = 0.0
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]  # (B, T, nkv, hd) views
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ wload(lp["wq"], dt)).reshape(B, S, nh, hd)
        k = (h @ wload(lp["wk"], dt)).reshape(B, S, nkv, hd)
        v = (h @ wload(lp["wv"], dt)).reshape(B, S, nkv, hd)
        q = _rope_rows(q, cos, sin)
        k = _rope_rows(k, cos, sin)
        ck[rows, cols] = k
        cv[rows, cols] = v
        qg = q.reshape(B, S, nkv, group, hd).permute(0, 2, 3, 1, 4)
        kt = ck.permute(0, 2, 1, 3)  # (B, nkv, T, hd)
        vt = cv.permute(0, 2, 1, 3)
        scores = torch.einsum("bngqh,bnkh->bngqk", qg, kt) / math.sqrt(hd)
        scores = scores.masked_fill(hidden, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        attn = torch.einsum("bngqk,bnkh->bngqh", probs, vt)
        attn = attn.permute(0, 3, 1, 2, 4).reshape(B, S, nh * hd)
        x = x + attn @ wload(lp["wo"], dt)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        if mlp_fn is None:
            gate = torch.nn.functional.silu(h @ wload(lp["w1"], dt))
            up = h @ wload(lp["w3"], dt)
            y = (gate * up) @ wload(lp["w2"], dt)
        else:
            y, e = mlp_fn(lp, h)
            extra = extra + e
        x = x + y
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ wload(params["head"], dt)).float()
    return logits, cache, extra


@torch.no_grad()
def ingest_slot_prompt(cfg: TransformerConfig, params: dict, cache: dict,
                       slot: int, prompt: torch.Tensor, plen: int,
                       mlp_fn=None):
    """The ONE copy of slot-prompt ingestion: forward the padded prompt
    (bucket,) from position 0 through the slot's slabs (a B=1 view, so
    the K/V land in place), and set the slot cursor to ``plen``.
    Returns ``(last_logits (V,), cache, extra)``; samplers layer on
    top."""
    sub = {
        "k": cache["k"][:, slot:slot + 1],
        "v": cache["v"][:, slot:slot + 1],
        "pos": cache["pos"][slot:slot + 1],
    }
    zero = torch.zeros((1,), dtype=torch.int32, device=prompt.device)
    logits, _, extra = _slot_forward(cfg, params, prompt[None, :], sub, zero,
                                     mlp_fn=mlp_fn)
    cache["pos"][slot] = plen
    return logits[0, plen - 1], cache, extra


def _engine_device(device: Any) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_on(params: dict, dev: torch.device, what: str) -> None:
    """Refuse a tree with a tensor off ``dev``: nothing is moved
    quietly."""
    for t in tree_leaves(params):
        if isinstance(t, torch.Tensor) and t.device != dev:
            raise ValueError(f"{what} has a tensor on {t.device}, the engine "
                             f"runs on {dev}; move the tree first")


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: list[int]
    prompt_len: int
    steps_waited: int  # engine ticks queued before admission
    ttft_s: float = 0.0  # wall time submit -> first token
    latency_s: float = 0.0  # wall time submit -> completion


class ContinuousBatcher:
    """The slot engine. Host-side control, two device functions
    (slot-prefill, slot-decode) and the prefix-cache install.

    ``submit`` enqueues; ``step()`` admits into free slots, advances
    one decode token for every active slot, and returns finished
    :class:`Completion`s. All shapes static: ``n_slots`` lanes,
    prompts padded to ``prompt_bucket``, caches sized ``max_len``.
    ``device=None`` means the card (and raises without one); the params
    must already live there.
    """

    def __init__(self, cfg: TransformerConfig, params: dict,
                 n_slots: int = 4, prompt_bucket: int = 64,
                 max_len: int | None = None, temperature: float = 0.0,
                 eos_id: int | None = None, seed: int = 0,
                 mesh=None, prefix_cache_size: int = 0,
                 clock=None, mlp_fn=None, submit_hook=None,
                 device: Any = None):
        if mesh is not None:
            raise ValueError(_MESH_MISSING)
        self.cfg = cfg
        # Front-door seam: called as ``submit_hook(rid, prompt_len,
        # max_new)`` on EVERY accepted submit — through a gateway or
        # around it — so a gateway-managed engine can count admission
        # bypasses.
        self.submit_hook = submit_hook
        # Latency-stat clock: seconds, monotonic. Injectable so TTFT /
        # completion latencies can be accounted in virtual time.
        self._now = clock or time.monotonic
        # FFN swap (same seam as the reference's): MoE serving plugs in
        # here.
        self.mlp_fn = mlp_fn
        self.n_slots = n_slots
        self.bucket = prompt_bucket
        self.max_len = max_len or cfg.max_seq
        if self.bucket >= self.max_len:
            raise ValueError("prompt_bucket must be < max_len")
        self.temperature = temperature
        self.eos_id = eos_id
        self.mesh = mesh
        self.device = _engine_device(device)
        _check_on(params, self.device, "params")
        self.params = params
        self._init_device_state()
        self.seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._ids = itertools.count()
        self.queue: deque = deque()
        # host-side slot table
        self.slot_req: list[int | None] = [None] * n_slots
        self.slot_tokens: list[list[int]] = [[] for _ in range(n_slots)]
        self.slot_remaining = np.zeros(n_slots, np.int32)
        self.slot_prompt_len = np.zeros(n_slots, np.int32)
        self.slot_waited = np.zeros(n_slots, np.int32)
        self.slot_ttft = np.zeros(n_slots, np.float64)
        self.slot_submit_t = np.zeros(n_slots, np.float64)
        self._submitted_step: dict[int, int] = {}
        self._submitted_t: dict[int, float] = {}
        # completed-request latency record (SLO surface): bounded
        self._ttfts: deque = deque(maxlen=1024)
        self._latencies: deque = deque(maxlen=1024)
        self.active = np.zeros(n_slots, bool)
        self.last_tok = np.zeros(n_slots, np.int32)
        self.steps = 0
        self.tokens_emitted = 0
        self.requests_completed = 0
        # This tick's admissions (subclass hook; see _admit).
        self._admitted: list = []
        # FFN auxiliary telemetry (MoE: drop fraction), averaged over
        # forwards.
        self._mlp_extra_sum = 0.0
        self._mlp_extra_n = 0
        # Exact-prompt prefix cache (system-prompt reuse): LRU of
        # {prompt bytes -> prompt-window KV + last-position logits}, on
        # the device. The slabs are updated in place, so an entry is a
        # COPY of its window: a view would be rewritten by the next
        # prompt admitted into the same slot. A hit installs the KV
        # into the slot and samples the first token from the cached
        # logits — zero prefill compute. 0 = off.
        self.prefix_cache_size = prefix_cache_size
        self._prefix_cache: "OrderedDict[bytes, dict]" = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefill_count = 0  # real prefill dispatches (cache misses)
        self._warm_up()

    # -- the device functions ---------------------------------------------

    def _init_device_state(self) -> None:
        """Allocate the KV slabs and cursors on the engine's device."""
        self.cache = init_slot_cache(self.cfg, self.n_slots, self.max_len,
                                     self.device)

    def _device_prompt(self, padded: np.ndarray) -> torch.Tensor:
        return torch.tensor(padded, dtype=torch.int32, device=self.device)

    def _prefill(self, slot: int, padded: np.ndarray, plen: int):
        """Write one request's prompt into ``slot`` and sample its first
        token. Returns (first (device scalar), last-position logits,
        extra)."""
        last_logits, self.cache, extra = ingest_slot_prompt(
            self.cfg, self.params, self.cache, slot,
            self._device_prompt(padded), plen, mlp_fn=self.mlp_fn)
        first = _sample(last_logits[None, :], self._gen, self.temperature)[0]
        return first, last_logits, extra

    def _install(self, slot: int, kwin: torch.Tensor, vwin: torch.Tensor,
                 plen: int) -> None:
        """Prefix-cache hit: copy the cached prompt-window KV
        (L, 1, bucket, nkv, hd) into ``slot``; no forward at all."""
        self.cache["k"][:, slot:slot + 1, :self.bucket] = kwin
        self.cache["v"][:, slot:slot + 1, :self.bucket] = vwin
        self.cache["pos"][slot] = plen

    def _decode(self, last_tok: np.ndarray, active: np.ndarray):
        """One token for every slot; inactive lanes masked. The host
        arrays are copied to the device here, before the caller
        rewrites them. Returns (next tokens (device), extra)."""
        tok = torch.tensor(last_tok, dtype=torch.int32, device=self.device)
        act = torch.tensor(active, dtype=torch.bool, device=self.device)
        logits, self.cache, extra = _slot_forward(
            self.cfg, self.params, tok[:, None], self.cache,
            self.cache["pos"], mlp_fn=self.mlp_fn)
        nxt = _sample(logits[:, 0, :], self._gen, self.temperature)
        nxt = torch.where(act, nxt, 0)
        self.cache["pos"] += act.to(torch.int32)
        return nxt, extra

    def _warm_up(self) -> None:
        """Run each device function once now, so first launches, library
        handles and the allocator's first blocks land at construction,
        not in the first request's TTFT; then reset the device state
        (slabs, cursors, sampler) to a fresh engine's. No counter, no
        queue and no host slot state is touched."""
        self._prefill(0, np.zeros(self.bucket, np.int32), 1)
        if self.prefix_cache_size:
            win = self.cache["k"][:, 0:1, :self.bucket].clone()
            self._install(0, win, win, 1)
        self._warm_decode()
        self._reset_device_state()

    def _warm_decode(self) -> None:
        """The warm-up's decode: the tick's own device function, on
        every lane masked."""
        n = self.n_slots
        self._decode(np.zeros(n, np.int32), np.zeros(n, bool))

    def _reset_device_state(self) -> None:
        for t in self.cache.values():
            t.zero_()
        self._gen.manual_seed(self.seed)

    # -- request intake ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 0 < len(prompt) <= self.bucket:
            raise ValueError(
                f"prompt length {len(prompt)} not in (0, {self.bucket}]")
        if max_new_tokens < 1:
            # prefill always samples one token; a zero-budget request
            # would still emit it and break caller-side accounting
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        rid = next(self._ids)
        self.queue.append((rid, prompt, int(max_new_tokens)))
        self._submitted_step[rid] = self.steps
        self._submitted_t[rid] = self._now()
        if self.submit_hook is not None:
            self.submit_hook(rid, len(prompt), int(max_new_tokens))
        return rid

    # -- the engine tick --------------------------------------------------

    def _admit(self) -> None:
        # (slot, padded_prompt, plen) of this tick's admissions — the
        # hook subclasses use to mirror work per new tenant (the
        # speculative engine draft-prefills the same prompt).
        self._admitted = []
        for slot in range(self.n_slots):
            if self.active[slot] or not self.queue:
                continue
            rid, prompt, max_new = self.queue.popleft()
            padded = np.zeros(self.bucket, np.int32)
            padded[:len(prompt)] = prompt
            self._admitted.append((slot, padded, len(prompt)))
            pkey = prompt.tobytes()
            ent = (self._prefix_cache.get(pkey)
                   if self.prefix_cache_size else None)
            if ent is not None:
                # Hit: install cached KV, sample from cached logits —
                # the prompt forward is skipped entirely.
                self._prefix_cache.move_to_end(pkey)
                self.prefix_hits += 1
                self._install(slot, ent["k"], ent["v"], int(ent["plen"]))
                first = int(_sample(ent["logits"][None, :], self._gen,
                                    self.temperature)[0])
            else:
                first, last_logits, extra = self._prefill(
                    slot, padded, len(prompt))
                first = int(first)
                self._mlp_extra_sum += float(extra) / self.cfg.n_layers
                self._mlp_extra_n += 1
                self.prefill_count += 1
                if self.prefix_cache_size:
                    self.prefix_misses += 1
                    self._prefix_cache[pkey] = {
                        "k": self.cache["k"][:, slot:slot + 1,
                                             :self.bucket].clone(),
                        "v": self.cache["v"][:, slot:slot + 1,
                                             :self.bucket].clone(),
                        "logits": last_logits.clone(),
                        "plen": len(prompt),
                    }
                    while len(self._prefix_cache) > self.prefix_cache_size:
                        self._prefix_cache.popitem(last=False)
            self.slot_req[slot] = rid
            self.slot_tokens[slot] = [first]
            self.slot_prompt_len[slot] = len(prompt)
            self.slot_remaining[slot] = max_new - 1
            self.slot_waited[slot] = (
                self.steps - self._submitted_step.pop(rid, self.steps))
            now = self._now()
            t_submit = self._submitted_t.pop(rid, now)
            self.slot_submit_t[slot] = t_submit
            self.slot_ttft[slot] = now - t_submit  # first token sampled
            self.active[slot] = True
            self.last_tok[slot] = first
            self.tokens_emitted += 1

    def _retire(self, slot: int) -> Completion:
        lat = self._now() - float(self.slot_submit_t[slot])
        ttft = float(self.slot_ttft[slot])
        comp = Completion(
            request_id=self.slot_req[slot],
            tokens=list(self.slot_tokens[slot]),
            prompt_len=int(self.slot_prompt_len[slot]),
            steps_waited=int(self.slot_waited[slot]),
            ttft_s=ttft,
            latency_s=lat,
        )
        self._ttfts.append(ttft)
        self._latencies.append(lat)
        self.requests_completed += 1
        self.slot_req[slot] = None
        self.slot_tokens[slot] = []
        self.active[slot] = False
        return comp

    def _pre_decode(self) -> tuple[list[Completion], bool]:
        """The tick prologue every engine shares: admit waiting
        requests, retire already-finished slots (prefill-only budgets,
        EOS sampled at admission). Returns (completions, any_active);
        when nothing is active the tick is already accounted."""
        self._admit()
        done: list[Completion] = []
        for slot in range(self.n_slots):
            if self.active[slot] and (
                    self.slot_remaining[slot] <= 0
                    or (self.eos_id is not None
                        and self.last_tok[slot] == self.eos_id)):
                done.append(self._retire(slot))
        if not self.active.any():
            self.steps += 1
            return done, False
        return done, True

    def _emit(self, slot: int, tok: int) -> bool:
        """Book one decoded token into ``slot``; True if the slot just
        finished (budget or EOS) — the ONE copy of the retire
        condition both engines' emit loops use."""
        self.slot_tokens[slot].append(tok)
        self.last_tok[slot] = tok
        self.slot_remaining[slot] -= 1
        self.tokens_emitted += 1
        return bool(
            self.slot_remaining[slot] <= 0
            or (self.eos_id is not None and tok == self.eos_id))

    def step(self) -> list[Completion]:
        """Admit waiting requests, decode one token for every active
        slot, retire finished requests. Returns completions."""
        done, any_active = self._pre_decode()
        if not any_active:
            return done
        nxt, extra = self._decode(self.last_tok, self.active)
        nxt = nxt.cpu().numpy()  # the tick's one host read
        self._mlp_extra_sum += float(extra) / self.cfg.n_layers
        self._mlp_extra_n += 1
        for slot in range(self.n_slots):
            if not self.active[slot]:
                continue
            if self._emit(slot, int(nxt[slot])):
                done.append(self._retire(slot))
        self.steps += 1
        return done

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.active.any())

    @staticmethod
    def _pct(values, q: float) -> float:
        # Nearest-rank (utils.stats): an observed sample at the
        # ceil(q*n)-th rank.
        return nearest_rank(values, q)

    def stats(self) -> dict:
        """Engine + SLO surface: time-to-first-token and completion
        latency percentiles over the last 1024 completions — the
        numbers a serving tenant's latency SLO is written against."""
        return {
            "steps": self.steps,
            "active_slots": int(self.active.sum()),
            "queued": len(self.queue),
            "tokens_emitted": self.tokens_emitted,
            "completed": self.requests_completed,
            "window": len(self._latencies),
            "ttft_p50_s": round(self._pct(self._ttfts, 0.50), 6),
            "ttft_p99_s": round(self._pct(self._ttfts, 0.99), 6),
            "latency_p50_s": round(self._pct(self._latencies, 0.50), 6),
            "latency_p99_s": round(self._pct(self._latencies, 0.99), 6),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            # FFN auxiliary mean (MoE: drop fraction; 0 for dense).
            "mlp_extra_mean": round(
                self._mlp_extra_sum / self._mlp_extra_n, 6)
            if self._mlp_extra_n else 0.0,
        }


class SpeculativeBatcher(ContinuousBatcher):
    """Continuous batching WITH speculative decoding: every engine
    tick, a draft model proposes ``k`` tokens per slot and the target
    verifies all ``k+1`` positions in ONE forward; each slot advances
    by its own accepted prefix (the per-row cursors of
    ``speculative.make_per_row_speculative_generate``).

    Greedy-only (``temperature=0``): acceptance is exact token match,
    so outputs are token-identical to the plain engine's. Static shapes
    throughout: the tick runs a fixed (n_slots, k) draft loop + one
    (n_slots, k+1) verify regardless of acceptance; finished/inactive
    lanes ride along masked.

    Truncation safety: a slot that hits EOS or its token budget
    mid-window retires immediately, so the device cursor (which
    advanced past the truncation) is never decoded from again — the
    next tenant's prefill rewrites it.
    """

    def __init__(self, cfg: TransformerConfig, params: dict,
                 draft_cfg: TransformerConfig, draft_params: dict,
                 k: int = 4, draft_mlp_fn=None, **kw):
        if kw.get("temperature", 0.0) != 0.0:
            raise ValueError(
                "SpeculativeBatcher is greedy-only (temperature=0): "
                "exact-match acceptance is the correctness contract")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if cfg.vocab != draft_cfg.vocab:
            raise ValueError("draft vocab != target vocab")
        # The draft side is set before the parent's constructor, whose
        # warm-up runs this engine's tick (the draft's functions too).
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.draft_mlp_fn = draft_mlp_fn
        self.k = k
        self.spec_proposed = 0
        self.spec_accepted = 0
        # Draft-side FFN telemetry (a starved MoE draft collapses
        # acceptance silently; this is its alarm).
        self._draft_extra_sum = 0.0
        self._draft_extra_n = 0
        super().__init__(cfg, params, **kw)

    def _init_device_state(self) -> None:
        super()._init_device_state()
        _check_on(self.draft_params, self.device, "draft_params")
        self.dcache = init_slot_cache(self.draft_cfg, self.n_slots,
                                      self.max_len, self.device)

    def _warm_decode(self) -> None:
        n = self.n_slots
        self._draft_prefill(0, np.zeros(self.bucket, np.int32), 1)
        self._spec_decode(np.zeros(n, np.int32), np.zeros(n, bool))

    def _reset_device_state(self) -> None:
        super()._reset_device_state()
        for t in self.dcache.values():
            t.zero_()

    def _draft_prefill(self, slot: int, padded: np.ndarray, plen: int):
        """Mirror of the target prefill for the draft cache: the shared
        ingest, logits discarded (the target picks tokens)."""
        _, self.dcache, extra = ingest_slot_prompt(
            self.draft_cfg, self.draft_params, self.dcache, slot,
            self._device_prompt(padded), plen, mlp_fn=self.draft_mlp_fn)
        return extra

    def _spec_decode(self, last_tok: np.ndarray, active: np.ndarray):
        """One speculation round across all slots at their own cursors.
        Returns (toks (B, k+1), advance per row (B,), extra, draft
        extra), all but the extras on the device."""
        from pbs_tpu_torch.models.speculative import greedy_accept_window

        cur = torch.tensor(last_tok, dtype=torch.int32, device=self.device)
        act = torch.tensor(active, dtype=torch.bool, device=self.device)
        pos = self.cache["pos"].clone()  # == dcache["pos"] by invariant
        tok, dp, d_extra, props = cur, pos, 0.0, []
        for _ in range(self.k):
            logits, self.dcache, e = _slot_forward(
                self.draft_cfg, self.draft_params, tok[:, None], self.dcache,
                dp, mlp_fn=self.draft_mlp_fn)
            tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
            dp = dp + 1
            d_extra = d_extra + e
            props.append(tok)
        t = torch.stack(props, dim=1)  # (B, k)
        # Ingest t_k so draft KV reaches pos+k whatever acceptance.
        _, self.dcache, e2 = _slot_forward(
            self.draft_cfg, self.draft_params, tok[:, None], self.dcache, dp,
            mlp_fn=self.draft_mlp_fn)
        d_extra = d_extra + e2
        x = torch.cat([cur[:, None], t], dim=1)  # (B, k+1)
        logits, self.cache, extra = _slot_forward(
            self.cfg, self.params, x, self.cache, pos, mlp_fn=self.mlp_fn)
        g = logits.argmax(dim=-1).to(torch.int32)
        toks, m_row, _bonus = greedy_accept_window(t, g)
        adv = torch.where(act, m_row + 1, 0).to(torch.int32)
        self.cache["pos"].copy_(pos + adv)
        self.dcache["pos"].copy_(pos + adv)
        return toks, adv, extra, d_extra

    def submit(self, prompt, max_new_tokens: int) -> int:
        # The verify window writes up to k+1 positions past the
        # accepted frontier; reserve that slack in the slab.
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) + max_new_tokens + self.k + 1 > self.max_len:
            raise ValueError(
                "prompt + max_new_tokens + k + 1 exceeds max_len "
                "(speculation needs overshoot room)")
        return super().submit(prompt, max_new_tokens)

    def step(self) -> list[Completion]:
        done, any_active = self._pre_decode()
        for slot, padded, plen in self._admitted:
            d_extra = self._draft_prefill(slot, padded, plen)
            self._draft_extra_sum += \
                float(d_extra) / self.draft_cfg.n_layers
            self._draft_extra_n += 1
        if not any_active:
            return done
        toks, counts, extra, d_extra = self._spec_decode(self.last_tok,
                                                         self.active)
        # the tick's one host read: the window and each row's advance
        packed = torch.cat([toks, counts[:, None]], dim=1).cpu().numpy()
        toks, counts = packed[:, :-1], packed[:, -1]
        self._mlp_extra_sum += float(extra) / self.cfg.n_layers
        self._mlp_extra_n += 1
        # kk+1 draft forwards per tick, each a per-layer sum.
        self._draft_extra_sum += (float(d_extra)
                                  / (self.draft_cfg.n_layers
                                     * (self.k + 1)))
        self._draft_extra_n += 1
        # proposed = k per active row; accepted = advance - 1 per row
        self.spec_proposed += self.k * int(self.active.sum())
        self.spec_accepted += int((counts[self.active] - 1).sum())
        for slot in range(self.n_slots):
            if not self.active[slot]:
                continue
            for j in range(int(counts[slot])):
                if self._emit(slot, int(toks[slot, j])):
                    # Truncate mid-window: the device cursor is ahead,
                    # but this slot retires NOW, so it is never decoded
                    # from again.
                    done.append(self._retire(slot))
                    break
        self.steps += 1
        return done

    def stats(self) -> dict:
        st = super().stats()
        st["spec_proposed"] = self.spec_proposed
        st["spec_accepted"] = self.spec_accepted
        st["spec_acceptance"] = round(
            self.spec_accepted / self.spec_proposed, 4) \
            if self.spec_proposed else 0.0
        st["draft_mlp_extra_mean"] = round(
            self._draft_extra_sum / self._draft_extra_n, 6) \
            if self._draft_extra_n else 0.0
        return st


def make_continuous_serve_step(engine: ContinuousBatcher,
                               next_requests=None):
    """Job-shaped wrapper: one engine tick per step (one token across
    slots — a quantum-sized unit, so the credit scheduler interleaves
    serving with training at token granularity). ``next_requests(step)``
    optionally feeds new (prompt, max_new) pairs each tick. The
    ``tokens`` metric is the tick's DELTA of the engine's emitted
    counter, so the TOKENS ledger slot is exact goodput."""

    def serve_step(state):
        step = int(state["step"])
        if next_requests is not None:
            for prompt, max_new in next_requests(step):
                engine.submit(prompt, max_new)
        before = engine.tokens_emitted
        done = engine.step()
        state = {"step": step + 1,
                 "completed": state["completed"] + len(done)}
        return state, {"tokens": engine.tokens_emitted - before}

    return serve_step
