"""Weights and token rows, made on the device from the run's seed.

Each leaf has a generator of its own, seeded from (seed, role, leaf),
so one leaf can be made again alone: the reference re-makes the
training tenant's first weights leaf by leaf after the window. Matrices
and the embedding are N(0, initializer_range), norms are ones, all in
the layer-stacked layout the port's models take (products stored as
(in, out)); each layer of a stacked leaf is one call, in the type the
tenant keeps them in.
"""

from __future__ import annotations

import zlib

import torch


def seed_for(seed: int, salt: str, index: int) -> int:
    return (int(seed) * 1_000_003 + zlib.crc32(salt.encode()) * 131
            + int(index)) % (2 ** 63)


def leaf_specs(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(dotted name, shape, "normal" | "ones") of every leaf, in order."""
    d, f, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    L, hd = cfg["num_hidden_layers"], cfg["head_dim"]
    hq = cfg["num_attention_heads"] * hd
    hkv = cfg["num_key_value_heads"] * hd
    layers = [("attn_norm", (L, d), "ones"), ("wq", (L, d, hq), "normal"),
              ("wk", (L, d, hkv), "normal"), ("wv", (L, d, hkv), "normal"),
              ("wo", (L, hq, d), "normal"), ("mlp_norm", (L, d), "ones")]
    if "num_local_experts" in cfg:
        E = cfg["num_local_experts"]
        layers += [("router", (L, d, E), "normal"),
                   ("we1", (L, E, d, f), "normal"),
                   ("we3", (L, E, d, f), "normal"),
                   ("we2", (L, E, f, d), "normal")]
    else:
        layers += [("w1", (L, d, f), "normal"), ("w3", (L, d, f), "normal"),
                   ("w2", (L, f, d), "normal")]
    return ([("embed", (V, d), "normal")]
            + [("layers." + n, s, k) for n, s, k in layers]
            + [("final_norm", (d,), "ones"), ("head", (d, V), "normal")])


def make_leaf(cfg: dict, name: str, seed: int, salt: str,
              dtype: torch.dtype, device) -> torch.Tensor:
    specs = leaf_specs(cfg)
    index = [n for n, _, _ in specs].index(name)
    _, shape, kind = specs[index]
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(
        seed_for(seed, salt, index))
    out = torch.empty(shape, dtype=dtype, device=device)
    parts = out if name.startswith("layers.") else out[None]
    for part in parts:
        torch.randn(part.shape, generator=gen, dtype=dtype, device=device,
                    out=part)
    return out.mul_(cfg["initializer_range"])


def make_tree(cfg: dict, seed: int, salt: str, dtype: torch.dtype,
              device) -> dict:
    """The whole tree, as the port's ``params`` dict."""
    tree: dict = {"layers": {}}
    for name, _, _ in leaf_specs(cfg):
        leaf = make_leaf(cfg, name, seed, salt, dtype, device)
        if name.startswith("layers."):
            tree["layers"][name[len("layers."):]] = leaf
        else:
            tree[name] = leaf
    return tree


def token_rows(seed: int, salt: str, index: int, shape: tuple, vocab: int,
               device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(
        seed_for(seed, salt, index))
    return torch.randint(0, vocab, shape, generator=gen, device=device)
