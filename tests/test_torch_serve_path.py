"""chip_smoke's phase 3v (the serving tier) at toy width on the host.

``chip_smoke.serve_path`` runs as on the card, with ``device="cpu"`` and
3s's script (prompts folded into the toy vocabulary): (a)
``ShardedServeBackend`` at 1x1 behind the port's gateway, its tokens held
to the reference's ``ContinuousBatcher`` on the same weights (the
reference's init carried across) driven by the same arrivals; (b)
``DisaggServeBackend`` against (a); (c) the tp2 engines (dense, int8,
dropless MoE, and the dense one in fp32 at the reduced depth) on two gloo
rank processes against one process's engine; (d) ``pbst-torch serve
stats|demo [--disagg] --device cpu`` in child processes. The phase's checks are fatal; in fp32 every token must also
be exact (no near-tie passes), the probe prefills' logits must agree
within fp32 reassociation, and the tp2 ranks must hold half the kv heads
and exchange at every decode tick.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from pbs_tpu import models as ref  # noqa: E402
from pbs_tpu_torch import models as port  # noqa: E402

torch.set_num_threads(2)

TOY = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=512)
TOY_MOE = dict(TOY, d_ff=32, n_experts=4, top_k=2)
REQUESTS = 12


def test_serve_phase_at_toy_width():
    import chip_smoke

    reqs, arrivals = chip_smoke.engine_script()
    reqs = [(p % TOY["vocab"], n) for p, n in reqs[:REQUESTS]]
    arrivals = {t: [i for i in idx if i < REQUESTS]
                for t, idx in arrivals.items()}
    arrivals = {t: idx for t, idx in arrivals.items() if idx}
    jcfg = ref.TransformerConfig(**TOY, dtype=jnp.float32)
    jparams = ref.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port.TransformerConfig(**TOY, dtype=torch.float32)
    params = port.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    "cpu")
    kw = dict(n_slots=chip_smoke.ENGINE_SLOTS,
              prompt_bucket=chip_smoke.ENGINE_BUCKET,
              max_len=chip_smoke.ENGINE_MAX_LEN)
    want = chip_smoke.drive_engine(
        torch, ref.ContinuousBatcher(jcfg, jparams, **kw), reqs, arrivals)
    a_tokens = {i: list(c.tokens) for i, c in want["done"].items()}

    out = chip_smoke.serve_path(
        torch, cfg, params, a_tokens, reqs, arrivals,
        dict(TOY, dtype="float32"), dict(TOY_MOE, dtype="float32"), 1,
        "cpu", "host", demo_device="cpu")
    assert not dist.is_initialized()
    assert "near-ties []" in out["lines"]["a"]
    assert "near-ties []" in out["lines"]["b"]
    assert set(out["runs"]) == {"dense", "int8", "moe", "fp32"}
    for family, run in out["runs"].items():
        assert run["ties"] == [], family
        assert run["logits_dev"] < 1e-4, family  # fp32 reassociation
        for r in run["ranks"]:
            assert r["local_kv_heads"] == TOY["n_kv_heads"] // 2
            assert r["stats"]["mesh"] == {"dp": 1, "tp": 2}
            assert r["stats"]["completed"] == REQUESTS
            assert r["stats"]["param_leaves"] == \
                out["runs"][family]["ranks"][0]["stats"]["param_leaves"]
            # the lookup, wo and w2 per layer, the logits, the tick check
            layers = TOY["n_layers"] if family == "dense" else 1
            assert r["exchanges"] == 2 * layers + 3, (family, r)
            assert r["staged_bytes"] == 0  # CPU tensors: nothing staged
    launches, _ = out["ab_launches"]
    assert set(launches.values()) == {0}
    kids = out["children"]
    assert kids["demo"]["completions"] == chip_smoke.SERVE_DEMO_REQUESTS
    assert kids["disagg"]["serve"]["handoffs"] == \
        chip_smoke.SERVE_DEMO_REQUESTS
