"""Speculative decoding: draft-model propose-k, target verify-in-one.

The port of ``pbs_tpu.models.speculative``. Each speculation round does
a fixed amount of work — k draft decode steps plus ONE target forward
over k+1 tokens — and advances by the accepted prefix plus the bonus
token. The reference's ``lax.scan``/``while_loop`` are Python loops
here, and the round condition is read on the host once per round (the
round's one device-to-host read).

Greedy (temperature=0) semantics, and therefore **token-exact**: the
output is identical to plain greedy decoding of the target model.
The lockstep variant synchronises acceptance across a batch at the
batch minimum (rows that verified further re-propose the same
deterministic tokens next round), which keeps the KV caches' scalar
``pos`` shared across rows; the per-row variant gives each row its own
cursor on the serving engine's slot machinery.

Cache rollback is position arithmetic: ``pos`` is authoritative, the
slab tail past it is both masked in cached attention and overwritten by
later writes, so "undo the unaccepted tokens" is ``cache["pos"] = p``
— no data movement.
"""

from __future__ import annotations

import numpy as np
import torch

from pbs_tpu_torch.models.generate import forward_with_cache, init_cache
from pbs_tpu_torch.models.serving import _slot_forward, init_slot_cache
from pbs_tpu_torch.models.transformer import TransformerConfig


def _check_args(cfg: TransformerConfig, draft_cfg: TransformerConfig,
                max_new_tokens: int, k: int) -> None:
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if cfg.vocab != draft_cfg.vocab:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab} != target vocab {cfg.vocab}")


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1).to(torch.int32)


def make_speculative_generate(
    cfg: TransformerConfig,
    draft_cfg: TransformerConfig,
    max_new_tokens: int,
    k: int = 4,
    target_fwd=None,
    draft_fwd=None,
):
    """Returns ``spec_generate(params, draft_params, prompt) ->
    (toks (B, max_new_tokens), stats)`` — greedy, token-exact vs the
    target's own greedy decode. ``stats``: rounds, proposed, accepted,
    reverified (ints; acceptance_rate = accepted / proposed).

    ``target_fwd``/``draft_fwd`` generalize over model families:
    ``fwd(params, tokens, cache) -> (logits, cache[, extra])``; the
    dense cached forward is the default.
    """
    _check_args(cfg, draft_cfg, max_new_tokens, k)

    if target_fwd is None:
        def target_fwd(params, tokens, cache):  # noqa: F811
            return forward_with_cache(cfg, params, tokens, cache)
    if draft_fwd is None:
        def draft_fwd(params, tokens, cache):  # noqa: F811
            return forward_with_cache(draft_cfg, params, tokens, cache)

    def _call(fwd, params, tokens, cache):
        out = fwd(params, tokens, cache)
        return out[0], out[1]  # tolerate (logits, cache, extra)

    @torch.no_grad()
    def spec_generate(params: dict, draft_params: dict,
                      prompt: torch.Tensor):
        B, P = prompt.shape
        dev = prompt.device
        # Room for the last round to overshoot by up to k+1 tokens.
        max_len = P + max_new_tokens + k + 1
        tcache = init_cache(cfg, B, max_len=max_len, device=dev)
        dcache = init_cache(draft_cfg, B, max_len=max_len, device=dev)

        tlogits, tcache = _call(target_fwd, params, prompt, tcache)
        _dl, dcache = _call(draft_fwd, draft_params, prompt, dcache)
        first = _argmax(tlogits[:, -1, :])  # (B,)

        out = torch.zeros((B, max_new_tokens + k + 1), dtype=torch.int32,
                          device=dev)
        out[:, 0] = first
        n_out, cur = 1, first
        rounds = proposed = accepted = reverified = 0
        while n_out < max_new_tokens:
            p0 = tcache["pos"]
            # Draft proposes k tokens (consuming cur..t_{k-1}).
            tok, props = cur, []
            for _ in range(k):
                logits, dcache = _call(draft_fwd, draft_params,
                                       tok[:, None], dcache)
                tok = _argmax(logits[:, -1])
                props.append(tok)
            t = torch.stack(props, dim=1)  # (B, k): t_1..t_k
            # Ingest t_k too so the draft has KV through position p0+k
            # whatever the acceptance (its logits are discarded).
            _, dcache = _call(draft_fwd, draft_params, tok[:, None], dcache)

            # Target verifies all k+1 positions in one forward.
            x = torch.cat([cur[:, None], t], dim=1)  # (B, k+1)
            logits, tcache = _call(target_fwd, params, x, tcache)
            g = _argmax(logits)  # (B, k+1)

            # Per-row accepted-prefix length; lockstep at the batch min.
            match = (t == g[:, :k]).to(torch.int32)
            m_row = torch.cumprod(match, dim=1).sum(dim=1)
            m_row = m_row.cpu().numpy()  # the round's one host read
            m = int(m_row.min())
            bonus = g[:, m]  # (B,): g_m per row
            # Tokens rows verified past the batch-min: they will be
            # re-proposed and re-verified next round.
            reverified += int((m_row - m).sum())

            # Emit t_1..t_m then the bonus; the static-width window may
            # carry junk past m+1 — the next round's write (or the
            # final slice) covers it.
            round_toks = torch.cat(
                [t, torch.zeros((B, 1), dtype=torch.int32, device=dev)],
                dim=1)
            round_toks[:, m] = bonus
            out[:, n_out:n_out + k + 1] = round_toks

            # Roll both caches back to the accepted frontier.
            tcache = dict(tcache, pos=p0 + m + 1)
            dcache = dict(dcache, pos=p0 + m + 1)
            n_out, cur = n_out + m + 1, bonus
            rounds, proposed, accepted = rounds + 1, proposed + k, \
                accepted + m
        stats = {"rounds": rounds, "proposed": proposed,
                 "accepted": accepted, "reverified": reverified}
        return out[:, :max_new_tokens], stats

    return spec_generate


def greedy_accept_window(t: torch.Tensor, g: torch.Tensor):
    """The ONE copy of greedy window acceptance, shared by the per-row
    generator and the speculative serving engine.

    ``t`` (B, k): draft proposals; ``g`` (B, k+1): target argmax over
    the verify window. Returns ``(toks (B, k+1), m_row (B,), bonus
    (B,))``, int32, where row b of ``toks`` holds its accepted prefix
    t_1..t_{m_b} with the bonus token g_{m_b} packed at column m_b
    (columns past m_b carry junk the caller's cursor arithmetic never
    reads)."""
    B, k = t.shape
    match = (t == g[:, :k]).to(torch.int32)
    m_row = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    bonus = torch.gather(g, 1, m_row[:, None].long())[:, 0]
    cols = torch.arange(k + 1, dtype=torch.int32, device=t.device)[None, :]
    toks = torch.cat([t, torch.zeros((B, 1), dtype=t.dtype, device=t.device)],
                     dim=1)
    toks = torch.where(cols == m_row[:, None], bonus[:, None], toks)
    return toks, m_row, bonus


def make_per_row_speculative_generate(
    cfg: TransformerConfig,
    draft_cfg: TransformerConfig,
    max_new_tokens: int,
    k: int = 4,
):
    """Per-row acceptance cursors: every row advances by ITS OWN
    accepted prefix each round, instead of the batch minimum, on the
    serving engine's per-slot machinery (``serving._slot_forward``:
    per-row rope gather, contiguous per-row KV writes, per-row causal
    horizon). Re-verification is structurally zero. Still greedy,
    still token-exact per row, still static shapes: a finished row is
    frozen by masking (advance 0), not by changing any shape.

    Dense family only — MoE speculation stays on the lockstep variant.
    """
    _check_args(cfg, draft_cfg, max_new_tokens, k)

    @torch.no_grad()
    def spec_generate(params: dict, draft_params: dict,
                      prompt: torch.Tensor):
        B, P = prompt.shape
        dev = prompt.device
        W = max_new_tokens + k + 1  # output window incl. overshoot
        max_len = P + W
        tcache = init_slot_cache(cfg, B, max_len, dev)
        dcache = init_slot_cache(draft_cfg, B, max_len, dev)
        zerop = torch.zeros((B,), dtype=torch.int32, device=dev)

        tlogits, tcache, _e = _slot_forward(cfg, params, prompt, tcache,
                                            zerop)
        _, dcache, _e = _slot_forward(draft_cfg, draft_params, prompt,
                                      dcache, zerop)
        first = _argmax(tlogits[:, -1, :])

        out = torch.zeros((B, W), dtype=torch.int32, device=dev)
        out[:, 0] = first
        cols = torch.arange(k + 1, device=dev)[None, :]
        n_out = torch.ones((B,), dtype=torch.int32, device=dev)
        n_out_h = np.ones(B, np.int64)
        cur, pos = first, zerop + P
        rounds = proposed = accepted = 0
        while n_out_h.min() < max_new_tokens:
            active_h = n_out_h < max_new_tokens
            active = n_out < max_new_tokens  # (B,) — frozen rows mask out

            # Draft proposes k tokens per row from its own cursor.
            tok, dp, props = cur, pos, []
            for _ in range(k):
                logits, dcache, _ = _slot_forward(
                    draft_cfg, draft_params, tok[:, None], dcache, dp)
                tok = _argmax(logits[:, -1])
                dp = dp + 1
                props.append(tok)
            t = torch.stack(props, dim=1)  # (B, k)
            # Ingest t_k so the draft holds KV through pos+k whatever
            # the acceptance (logits discarded; overwritten on rollback).
            _, dcache, _ = _slot_forward(draft_cfg, draft_params,
                                         tok[:, None], dcache, dp)

            # Target verifies k+1 positions per row at its own cursor;
            # per-row accepted prefix — NO batch-min.
            x = torch.cat([cur[:, None], t], dim=1)  # (B, k+1)
            logits, tcache, _ = _slot_forward(cfg, params, x, tcache, pos)
            round_toks, m_row, bonus = greedy_accept_window(t, _argmax(logits))
            # each row's window at its own output cursor (the start
            # clamped as dynamic_update_slice clamps it)
            start = n_out.clamp(max=W - (k + 1)).long()
            out_new = out.scatter(1, start[:, None] + cols, round_toks)
            out = torch.where(active[:, None], out_new, out)

            # Frozen rows advance nothing: cursor, count, cur all hold.
            adv = torch.where(active, m_row + 1, 0).to(torch.int32)
            pos = pos + adv
            cur = torch.where(active, bonus, cur)
            n_out = n_out + adv
            new_h = n_out.cpu().numpy()  # the round's one host read
            n_act = int(active_h.sum())
            rounds += 1
            proposed += k * n_act
            accepted += int((new_h - n_out_h)[active_h].sum()) - n_act
            n_out_h = new_h
        stats = {"rounds": rounds, "proposed": proposed,
                 "accepted": accepted, "reverified": 0}
        return out[:, :max_new_tokens], stats

    return spec_generate


def make_speculative_serve_step(
    cfg: TransformerConfig,
    draft_cfg: TransformerConfig,
    max_new_tokens: int,
    k: int = 4,
):
    """A Job-shaped speculative batch-inference loop (the spec-decode
    sibling of ``generate.make_serve_step``): ``state`` is
    (params, draft_params, requests_served); each step serves one
    prompt batch. Step metrics feed the telemetry ledger —
    ``tokens`` (Counter.TOKENS) and ``spec_proposed``
    (Counter.SPEC_PROPOSED). Uses the per-row variant: serving batches
    mix unrelated prompts, exactly where lockstep's batch-min
    re-verification tax is worst."""
    spec = make_per_row_speculative_generate(
        cfg, draft_cfg, max_new_tokens, k)

    def serve_step(state, prompts: torch.Tensor):
        params, draft_params, served = state
        toks, stats = spec(params, draft_params, prompts)
        metrics = {
            "tokens": toks.shape[0] * toks.shape[1],
            "spec_proposed": stats["proposed"],
        }
        return (params, draft_params, served + 1), metrics

    return serve_step
