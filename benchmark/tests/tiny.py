"""Tiny configurations and traffic for the benchmark's CPU tests: every
width cut, the cell's control flow kept."""

from benchmark import spec


def config(name: str) -> dict:
    c = dict(spec.config(name))
    c.update(hidden_size=64, head_dim=16, intermediate_size=128,
             num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=2, vocab_size=512,
             # the logits' spread of the full widths: 0.02 x sqrt(4096 / 64)
             initializer_range=0.16,
             # fp32 compute: the limits were read at the full widths in
             # bf16, so a sound run at this size lies far under them
             torch_dtype="float32")
    if "num_local_experts" in c:
        c.update(num_local_experts=4)
    return c


def mix(workload: str) -> dict:
    m = spec.traffic(spec.workload(spec.benchmark(), workload)["traffic"])
    t = m["tenants"]
    if "serve" in t:
        t["serve"] = dict(
            t["serve"],
            prompt_tokens={"median": 16, "sigma": 1.0, "min": 4, "max": 48},
            output_tokens={"median": 8, "sigma": 0.8, "min": 2, "max": 40},
            engine={"n_slots": 4, "prompt_bucket": 48, "max_len": 96,
                    "temperature": 0.0},
            drain_cap_s=30)
        m["rate_per_s"] = 8.0
    b = t["batch"]
    t["batch"] = (dict(b, micro_batch=[1, 64],
                       check=dict(b["check"], wait_s=10))
                  if b["kind"] == "train" else dict(b, rows=[2, 64]))
    return m


def run(workload: str, seed: int = 987654321012, seconds: float = 1.5,
        **kw):
    import torch

    from benchmark.harness import run_cell

    # one thread: test workers side by side on a few cores, each with a
    # thread per core, slow each other's tiny steps by tens of times
    torch.set_num_threads(1)
    w = spec.workload(spec.benchmark(), workload)
    return run_cell(spec.benchmark(), workload, seed, seconds, False, "cpu",
                    cfg_override=config(w["config"]),
                    mix_override=mix(workload), **kw)
