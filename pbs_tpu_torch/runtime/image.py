"""Job images: boot a tenant from on-disk artifacts (the pygrub analog).

The port of ``pbs_tpu.runtime.image``. pygrub reads a guest's disk
image, parses its bootloader config, extracts kernel+initrd, and hands
them to the domain builder. A *job image directory* is the workload's
self-describing boot medium:

    image.json  — the bootloader config: workload kind, model config,
                  training hyperparameters, sched params, data spec
    ckpt/       — optional checkpoint (the kernel/initrd: the state
                  that actually boots); absent = cold boot from init

The manifest and the checkpoint are the JAX package's formats, so an
image written by either package boots in the other. ``boot_job(path)``
parses the manifest, builds the port's model and train step
(``attn_impl: "pallas"`` routes attention through the flash kernels),
restores the checkpoint when present, and returns a ready
:class:`~pbs_tpu_torch.runtime.job.Job`. ``image_workload`` admits the
booted job into a port ``Partition``. ``save_image`` is the other
direction (the image builder).

Data kind ``"corpus"`` draws the reference's windows from the same
numpy generators, so both packages train on the same tokens. Kind
``"synthetic"`` draws from a ``torch.Generator`` seeded from ``seed +
1`` folded with the step, as the reference seeds its key; the port
never reproduces JAX PRNG streams, so synthetic tokens differ from the
reference's. Kind ``"moe"`` images boot the MoE family
(``models.moe``: ``MoEConfig``, ``init_moe_params``,
``make_moe_train_step``).
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.partition import Partition

MANIFEST_NAME = "image.json"
CKPT_DIR = "ckpt"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _resolve_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r} in image manifest")
    return _DTYPES[name]


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def save_image(path: str, kind: str, config: dict, *, state=None,
               sched: dict | None = None, train: dict | None = None,
               data: dict | None = None,
               metadata: dict | None = None) -> dict:
    """Write a bootable job image. ``config`` holds the model-config
    kwargs (dtype as a string); ``state`` (optional) checkpoints the
    current (params, opt_state, step) so the boot is warm."""
    from pbs_tpu_torch.ckpt.checkpoint import save_checkpoint

    os.makedirs(path, exist_ok=True)
    config = dict(config)
    if "dtype" in config and not isinstance(config["dtype"], str):
        # callers may pass a live dtype (e.g. torch.bfloat16); manifests
        # store the canonical name so images stay JSON + portable
        config["dtype"] = _dtype_name(config["dtype"])
    manifest = {
        "version": 1,
        "kind": kind,
        "config": config,
        "sched": sched or {},
        "train": {"learning_rate": 3e-4, "batch": 4, "seq": 256,
                  "seed": 0, **(train or {})},
        "data": data or {"kind": "synthetic"},
        "metadata": metadata or {},
        "has_ckpt": state is not None,
    }
    # Checkpoint FIRST, manifest last: the manifest rename is the
    # commit point, so a crash mid-save can only leave an image that
    # under-promises (stale manifest), never one that promises warm
    # state it doesn't have.
    if state is not None:
        save_checkpoint(os.path.join(path, CKPT_DIR), state,
                        metadata={"image": kind})
    tmp = os.path.join(path, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(path, MANIFEST_NAME))
    return manifest


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        m = json.load(f)
    if m.get("version") != 1:
        raise ValueError(f"unsupported image version {m.get('version')!r}")
    if m.get("kind") not in ("transformer", "moe"):
        raise ValueError(f"unknown image kind {m.get('kind')!r}")
    return m


def _make_batch_fn(data: dict, image_path: str, batch: int, seq: int,
                   vocab: int, seed: int, device: Any = None):
    """step -> (batch, seq) int32 tokens on ``device``, from the
    manifest's data spec. ``synthetic`` (default) needs no files;
    ``corpus`` memory-maps a packed token file — a RELATIVE path
    resolves inside the image directory, so an image can carry its own
    data shard and stay a fully self-contained boot medium."""
    from pbs_tpu_torch.models.transformer import resolve_device

    dev = resolve_device(device)
    kind = data.get("kind", "synthetic")
    if kind == "synthetic":
        def batch_fn(step: int):
            gen = torch.Generator().manual_seed(((seed + 1) << 32) + step)
            return torch.randint(0, vocab, (batch, seq), generator=gen,
                                 dtype=torch.int32).to(dev)

        return batch_fn
    if kind == "corpus":
        from pbs_tpu_torch.data.tokens import TokenDataset

        path = data.get("path")
        if not path:
            raise ValueError("corpus data spec needs 'path'")
        if not os.path.isabs(path):
            path = os.path.join(image_path, path)
        ds = TokenDataset(path)
        if seq > ds.n_tokens:
            # Loud at boot, not contained-as-job.error at step 0.
            raise ValueError(
                f"corpus {path!r} holds {ds.n_tokens} tokens — shorter "
                f"than one training sequence (seq={seq})")
        sequential = data.get("sampling", "random") == "sequential"

        def batch_fn(step: int):
            if sequential:
                rows = ds.window(step, batch, seq)
            else:
                # reproducible random windows: one generator per step
                rng = np.random.default_rng(seed * 1_000_003 + step)
                rows = ds.sample(batch, seq, rng)
            return torch.from_numpy(rows).to(dev)

        return batch_fn
    raise ValueError(f"unknown data kind {kind!r} in image manifest")


def _build(kind: str, config: dict, train: dict, data: dict,
           image_path: str, device: Any = None):
    """(cfg, init_state_fn, step_fn) for a manifest."""
    from pbs_tpu_torch.models import (
        MoEConfig,
        TransformerConfig,
        init_moe_params,
        init_params,
        make_moe_train_step,
        make_train_step,
    )
    from pbs_tpu_torch.models.transformer import resolve_device

    dev = resolve_device(device)
    cfg_kwargs = dict(config)
    if "dtype" in cfg_kwargs:
        cfg_kwargs["dtype"] = _resolve_dtype(cfg_kwargs["dtype"])
    lr = float(train.get("learning_rate", 3e-4))
    batch = int(train.get("batch", 4))
    seq = int(train.get("seq", 256))
    seed = int(train.get("seed", 0))

    if kind == "transformer":
        cfg = TransformerConfig(**cfg_kwargs)
        init_opt, train_step = make_train_step(cfg, learning_rate=lr)
        init_fn = init_params
    else:  # moe — validated by read_manifest
        cfg = MoEConfig(**cfg_kwargs)
        init_opt, train_step = make_moe_train_step(cfg, learning_rate=lr)
        init_fn = init_moe_params

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_fn(cfg, gen, device=dev)
        return (params, init_opt(params), 0)

    seq = min(seq, cfg.max_seq)
    batch_fn = _make_batch_fn(data, image_path, batch, seq, cfg.vocab,
                              seed, dev)

    def step_fn(state):
        tokens = batch_fn(int(state[2]))
        return train_step(state, tokens)

    return cfg, init_state, step_fn


def boot_job(path: str, name: str | None = None,
             max_steps: int | None = None, device: Any = None):
    """Boot a Job from an image directory (cold from init, warm from
    the bundled checkpoint) on ``device`` (the card unless "cpu"). The
    job is NOT yet admitted — hand it to ``Partition.add_job`` (or use
    ``image_workload``)."""
    from pbs_tpu_torch.ckpt.checkpoint import (checkpoint_exists,
                                               restore_checkpoint)
    from pbs_tpu_torch.runtime.job import Job, SchedParams

    m = read_manifest(path)
    cfg, init_state, step_fn = _build(
        m["kind"], m["config"], m["train"],
        m.get("data") or {"kind": "synthetic"}, path, device)
    state = init_state()
    ckpt = os.path.join(path, CKPT_DIR)
    if m.get("has_ckpt"):
        if not checkpoint_exists(ckpt):
            # Never silently cold-boot a warm image: restarting from
            # step 0 under the same name would discard all progress
            # without a trace (truncated copy / partial rsync).
            raise FileNotFoundError(
                f"image {path!r} promises a checkpoint (has_ckpt) but "
                f"{ckpt!r} has no manifest — refusing to cold-boot")
        state, _ = restore_checkpoint(ckpt, like=state)
    return Job(
        name or m["metadata"].get("name", os.path.basename(path.rstrip("/"))),
        step_fn=step_fn,
        state=state,
        params=SchedParams(**m.get("sched", {})),
        max_steps=max_steps if max_steps is not None
        else m["train"].get("max_steps"),
        label=str(m["metadata"].get("label", "user")),
    )


def image_workload(partition: "Partition", job_name: str,
                   spec: dict, device: Any = None) -> Any:
    """Boot ``spec={"path": <image dir>, ...}`` and admit it to
    ``partition`` — the ``xl create <image>`` flow. Extra spec keys
    override the manifest (sched, max_steps, label)."""
    path = spec.get("path")
    if not path:
        raise ValueError("image workload needs spec['path']")
    job = boot_job(path, name=job_name, max_steps=spec.get("max_steps"),
                   device=device)
    for k, v in (spec.get("sched") or {}).items():
        if not hasattr(job.params, k):
            # a typo'd knob silently running at defaults is worse than
            # a loud reject (the manifest path raises the same way)
            raise KeyError(f"unknown sched param {k!r} in image spec")
        setattr(job.params, k, v)
    if "label" in spec:
        job.label = str(spec["label"])
    return partition.add_job(job)
