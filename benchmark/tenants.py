"""The cell's tenants, built from the port's own entry points.

- ``serve``: a ``ContinuousBatcher`` behind the port's ``Gateway``
  through ``BatcherBackend``, as one ``Job`` whose step is one gateway
  tick; it sleeps when the gateway has nothing queued or in flight and
  an arrival wakes it.
- ``train``: ``make_micro_train_step`` (AdamW) as ``Job(micro_step_fn=
  ..., micro_per_step=K)``.
- ``score``: a no-grad forward over token rows; each row's
  log-likelihood of its next tokens is the answer.

The harness's own spans wrap the calls into the program: each engine
tick, prefill, micro-step and scoring step is timed on the host clock,
and in a traced run each of them and each gateway tick is named in the
profiler's trace. The metric readers read what they record; nothing
here changes what the program computes.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark import weights as W

now_ns = time.monotonic_ns


class Spans:
    """The harness's spans, named in the profiler's trace (a
    ``record_function`` range) when the run is traced; the tenants time
    what the readers need on the host clock themselves."""

    def __init__(self, traced: bool):
        self.traced = traced

    def __call__(self, name: str):
        return (torch.profiler.record_function(name) if self.traced
                else contextlib.nullcontext())


def port_config(cfg: dict, attn_impl: str = "xla", remat: str = ""):
    """The port's ``TransformerConfig`` (``MoEConfig`` for a model with
    experts) at the configuration's widths, computing in its stated
    ``torch_dtype``."""
    from pbs_tpu_torch.models import MoEConfig, TransformerConfig

    kw = dict(vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
              n_layers=cfg["num_hidden_layers"],
              n_heads=cfg["num_attention_heads"],
              n_kv_heads=cfg["num_key_value_heads"],
              d_ff=cfg["intermediate_size"], max_seq=8192,
              rope_theta=float(cfg["rope_theta"]),
              norm_eps=float(cfg["rms_norm_eps"]),
              dtype=getattr(torch, cfg["torch_dtype"]),
              attn_impl=attn_impl, remat=bool(remat),
              remat_policy=remat or "full")
    if cfg["hidden_size"] // cfg["num_attention_heads"] != cfg["head_dim"]:
        raise ValueError("the port takes head_dim = hidden / heads")
    if "num_local_experts" in cfg:
        return MoEConfig(**kw, n_experts=cfg["num_local_experts"],
                         top_k=cfg["num_experts_per_tok"], dropless=True)
    return TransformerConfig(**kw)


class ServeTenant:
    role = "serve"

    def __init__(self, cfg: dict, spec: dict, params: dict, part, fb,
                 spans: Spans, seed: int, device):
        from pbs_tpu_torch.gateway import (BatcherBackend, Gateway,
                                           TenantQuota, sched_feedback_sink)
        from pbs_tpu_torch.models import ContinuousBatcher
        from pbs_tpu_torch.models.moe import moe_slot_mlp
        from pbs_tpu_torch.runtime import Job
        from pbs_tpu_torch.utils.clock import MonotonicClock

        self.cfg, self.spec, self.part, self.spans = cfg, spec, part, spans
        self.params = params
        pcfg = port_config(cfg)
        eng = spec["engine"]
        self.engine = ContinuousBatcher(
            pcfg, params, n_slots=eng["n_slots"],
            prompt_bucket=eng["prompt_bucket"], max_len=eng["max_len"],
            temperature=eng["temperature"], seed=seed,
            mlp_fn=moe_slot_mlp(pcfg) if "num_local_experts" in cfg
            else None, device=device)
        self.backend = BatcherBackend("engine", self.engine)
        self.job = Job("serve", step_fn=self._step, state={"ticks": 0})
        big = float(1 << 40)
        self.gateway = Gateway(
            [self.backend],
            quotas={spec["tenant"]: TenantQuota(
                rate=big, burst=big, slo=spec["slo"], max_queued=1 << 30)},
            clock=MonotonicClock(), max_queued=1 << 30,
            feedback_sink=sched_feedback_sink(fb, self.job))
        self.requests: list[dict] = []
        self.ticks: list[tuple[int, int, int]] = []  # t0, t1, active slots
        self.gaps_ns: list[int] = []
        # (host ns, model FLOPs) of each prefill and each decoded token
        self.work: list[tuple[int, int]] = []
        self._first_at: dict[int, int] = {}
        self._wrap_engine()

    # -- spans around the engine's two device paths --------------------

    def _wrap_engine(self) -> None:
        eng = self.engine
        prefill, step = eng._prefill, eng.step

        def timed_prefill(slot, padded, plen):
            with self.spans("prefill"):
                out = prefill(slot, padded, plen)
                out[0].item()  # the first token is on the host from here
            self._first_at[slot] = now_ns()
            return out

        def timed_step():
            active = int(eng.active.sum())
            t0 = now_ns()
            with self.spans("engine_tick"):
                done = step()
            t1 = now_ns()
            self.ticks.append((t0, t1, active))
            self._book(done, t1)
            return done

        eng._prefill, eng.step = timed_prefill, timed_step

    def _req_of(self, erid: int) -> dict:
        return self.requests[self.backend._by_engine_rid[erid].payload["i"]]

    def _emit(self, req: dict, n_tokens: int, t: int, slot: int) -> None:
        """Book a request's tokens up to ``n_tokens``: the first at its
        prefill's end, each later one at the end of the tick that
        decoded it (token k came from the forward at position
        prompt + k - 1)."""
        from benchmark import flops as F

        if n_tokens <= req["n_tokens"]:
            return
        plen = len(req["prompt"])
        if req["n_tokens"] == 0:
            req["first_ns"] = self._first_at.pop(slot, t)
            req["last_ns"] = req["first_ns"]
            req["n_tokens"] = 1
            self.work.append((req["first_ns"], F.prefill_flops(self.cfg, plen)))
        for k in range(req["n_tokens"], n_tokens):
            self.gaps_ns.append(t - req["last_ns"])
            req["last_ns"] = t
            self.work.append((t, F.decode_flops(self.cfg, plen + k - 1)))
        req["n_tokens"] = n_tokens

    def _book(self, done, t: int) -> None:
        eng = self.engine
        for slot, erid in enumerate(eng.slot_req):
            if erid is not None:
                self._emit(self._req_of(erid), len(eng.slot_tokens[slot]), t,
                           slot)
        for comp in done:
            req = self._req_of(comp.request_id)
            self._emit(req, len(comp.tokens), t, -1)
            req["tokens"] = list(comp.tokens)
            req["done_ns"] = t

    # -- the Job's step and the arrivals -------------------------------

    def _step(self, state):
        before = self.engine.tokens_emitted
        with self.spans("gateway_tick"):
            self.gateway.tick()
        if not self.gateway.busy():
            self.part.sleep_job(self.job, notify=False)
        return ({"ticks": state["ticks"] + 1},
                {"tokens": self.engine.tokens_emitted - before})

    def arm(self, reqs: list[dict], t0_ns: int) -> None:
        """Arm one partition timer per request at its due time: the
        timer submits it to the gateway and wakes the serving job."""
        for r in reqs:
            rec = {"i": r["i"], "due_ns": t0_ns + int(r["due_s"] * 1e9),
                   "prompt": r["prompt"], "max_new": r["max_new"],
                   "submit_ns": None, "first_ns": None, "last_ns": None,
                   "n_tokens": 0, "tokens": None, "done_ns": None}
            self.requests.append(rec)
            self.part.timers.arm(rec["due_ns"], self._arrive(rec),
                                 name="bench_arrival")

    def _arrive(self, rec: dict):
        def fire(now: int) -> None:
            rec["submit_ns"] = now_ns()
            res = self.gateway.submit(
                self.spec["tenant"],
                {"prompt": rec["prompt"], "max_new": rec["max_new"],
                 "i": rec["i"]}, cost=1)
            if not res.admitted:
                raise RuntimeError(f"request {rec['i']} shed: {res.reason}")
            self.part.wake_job(self.job, notify=False)
        return fire

    def finished(self) -> int:
        return sum(1 for r in self.requests if r["tokens"])

    def pending_first(self, until_ns: int) -> bool:
        return any(r["first_ns"] is None for r in self.requests
                   if r["due_ns"] < until_ns)


class TrainTenant:
    role = "batch"

    def __init__(self, cfg: dict, spec: dict, seed: int, spans: Spans,
                 device):
        from pbs_tpu_torch.models import make_micro_train_step
        from pbs_tpu_torch.runtime import Job

        self.cfg, self.spec, self.seed, self.spans = cfg, spec, seed, spans
        self.device = device
        self.pcfg = port_config(cfg, spec["attn_impl"], spec["remat"])
        self.shape = tuple(spec["micro_batch"])
        self.K = spec["micro_per_step"]
        self.fed = 0
        params = W.make_tree(cfg, seed, "train", torch.float32, device)
        init, self._micro = make_micro_train_step(
            self.pcfg, self.K, learning_rate=spec["learning_rate"],
            next_batch=self._feed)
        self.job = Job("train", micro_step_fn=self._micro_step,
                       micro_per_step=self.K, state=init(params))
        self.steps: list[tuple[int, int, int]] = []  # t0, t1, tokens
        self.flash_shape = (self.shape[0], self.shape[1] - 1)
        # what the check compares, read from the window's first steps
        self.check_steps = spec["check"]["steps"]
        self.losses: list[float] = []
        self.grad_norms: dict[str, float] = {}
        self.change_norms: dict[str, float] = {}

    def rows(self, index: int) -> torch.Tensor:
        return W.token_rows(self.seed, "train", index, self.shape,
                            self.cfg["vocab_size"], self.device)

    def _feed(self, _micro_in_step: int) -> torch.Tensor:
        rows = self.rows(self.fed)
        self.fed += 1
        return rows

    def _micro_step(self, state):
        t0 = now_ns()
        with self.spans("train_micro_step"):
            state, m = self._micro(state)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.steps.append((t0, now_ns(), int(m["tokens"])))
        if len(self.losses) < self.K * self.check_steps:
            with self.spans("train_check_read"):
                self._read(state, m)
        return state, m

    def _read(self, state, m) -> None:
        """Read what the check compares from the window's own first
        steps as they retire: each micro-step's loss, the first
        gradient's norm by leaf as AdamW holds it after step 1 (m = (1 -
        b1) g), and each leaf's change once the last of them has retired,
        before the next moves it (the first weights made again from the
        seed, one leaf at a time)."""
        from pbs_tpu_torch.models.transformer import ADAM_B1

        self.losses.append(float(m["loss"]))
        if state["micro"] != 0:
            return
        if state["step"] == 1:
            self.grad_norms = {
                name: float(torch.linalg.vector_norm(mu)) / (1 - ADAM_B1)
                for name, mu in _named(state["opt"]["mu"])}
        if state["step"] == self.check_steps:
            for name, p in _named(state["params"]):
                p0 = W.make_leaf(self.cfg, name, self.seed, "train",
                                 torch.float32, self.device)
                self.change_norms[name] = float(
                    torch.linalg.vector_norm(p - p0))
                del p0

    def warm(self) -> None:
        """One optimizer step by the job's own micro-step, then the state
        as it was before it: the first weights made again from the seed
        in place, the moments and the accumulator zeroed, the counts and
        the feed back at 0. So the window's first steps start from the
        seed's weights, and are the ones the check compares."""
        for _ in range(self.K):
            self.job.state, _ = self._micro(self.job.state)
        st = self.job.state
        with torch.no_grad():
            for name, p in _named(st["params"]):
                p.copy_(W.make_leaf(self.cfg, name, self.seed, "train",
                                    torch.float32, self.device))
            for tree in (st["opt"]["mu"], st["opt"]["nu"], st["acc"]):
                for _, x in _named(tree):
                    x.zero_()
        self.job.state = dict(
            st, micro=0, step=0,
            opt=dict(st["opt"], count=torch.tensor(0, dtype=torch.int32)))
        self.fed = 0

    def first_steps(self) -> dict | None:
        """The readings of the window's first steps (each step's loss the
        mean of its micro-steps'), or None until the last has retired."""
        if not self.change_norms:
            return None
        K = self.K
        return {"losses": [sum(self.losses[s * K:(s + 1) * K]) / K
                           for s in range(self.check_steps)],
                "grad_norms": self.grad_norms,
                "change_norms": self.change_norms}

    def step_flops(self) -> int:
        from benchmark import flops as F

        return F.train_flops(self.cfg, *self.flash_shape)


class ScoreTenant:
    role = "batch"

    def __init__(self, cfg: dict, spec: dict, params: dict, seed: int,
                 spans: Spans, device):
        from pbs_tpu_torch.runtime import Job

        self.cfg, self.spec, self.seed, self.spans = cfg, spec, seed, spans
        self.device, self.params = device, params
        self.pcfg = port_config(cfg, spec["attn_impl"])
        self.shape = tuple(spec["rows"])
        self.job = Job("score", step_fn=self._step, state={"j": 0})
        self.steps: list[tuple[int, int, int]] = []
        self.answers: dict[int, torch.Tensor] = {}
        self.flash_shape = self.shape

    def rows(self, index: int) -> torch.Tensor:
        return W.token_rows(self.seed, "score", index, self.shape,
                            self.cfg["vocab_size"], self.device)

    @torch.no_grad()
    def _forward(self, rows: torch.Tensor) -> torch.Tensor:
        from pbs_tpu_torch.models import forward, moe_forward

        if "num_local_experts" in self.cfg:
            logits = moe_forward(self.pcfg, self.params, rows)[0]
        else:
            logits = forward(self.pcfg, self.params, rows)
        logp = torch.log_softmax(logits, dim=-1)
        return logp[:, :-1].gather(-1, rows[:, 1:, None].long())[..., 0]

    def _step(self, state):
        j = state["j"]
        t0 = now_ns()
        with self.spans("score_step"):
            self.answers[j] = self._forward(self.rows(j))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.steps.append((t0, now_ns(), self.shape[0] * self.shape[1]))
        return {"j": j + 1}, {"tokens": self.shape[0] * self.shape[1]}

    def warm(self) -> None:
        self.job.state, _ = self._step(self.job.state)
        self.job.state = {"j": 0}
        self.answers.clear()
        self.steps.clear()

    def step_flops(self) -> int:
        from benchmark import flops as F

        return F.forward_flops(self.cfg, *self.shape)


def _named(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _named(v, f"{prefix}{k}.")
        else:
            out.append((prefix + k, v))
    return out
