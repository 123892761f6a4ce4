"""Regex-rule parameter partitioning for the serving tier.

The port of ``pbs_tpu.serve.partition``. The training stack annotates
shardings per-leaf in code (``parallel/sharding.param_specs``); the
serving tier instead carries ONE declarative rule table — ordered
``(path regex, positional spec)`` pairs in the fmengine
``match_partition_rules`` style — because a serving deployment swaps
checkpoints whose trees it does not own. Matching walks the param tree
with ``/``-joined paths, scalars are never partitioned, the FIRST
matching rule wins, and an unmatched leaf is a hard error: silently
replicating an unmatched 8 GB embedding is exactly the failure mode a
rule table exists to prevent.

Specs are written with POSITIONAL mesh-axis indices: ``-1`` is "the
innermost mesh axis" — by repo convention the tensor axis — so the
table never names an axis and library code stays mesh-agnostic. Only
:func:`make_serve_mesh` (this module) and ``pbs_tpu_torch/parallel``
may spell axis NAMES; the ``serve-raw-mesh-axis`` rule of
``pbst-torch check`` holds every other module to that. Resolution
against a concrete mesh reuses ``parallel/sharding.quant_aware_shardings``,
so int8 ``{"q","s"}`` checkpoint leaves place exactly like their fp
twins.

Where the port parts from the reference: a sharding cuts a full tree
down to this rank's blocks (SPMD by rank, as ``parallel/``), so
``shard`` returns this rank's blocks and ``gather`` is a collective that
returns the full tree on every rank. A 1x1 serving mesh needs no
``torch.distributed`` world (``parallel.mesh.one_rank_mesh``); a larger
one spans the whole world, so a serving mesh smaller than the world is
refused.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Iterable

import numpy as np

from pbs_tpu_torch.parallel.mesh import (
    Mesh,
    PartitionSpec as P,
    make_mesh,
    one_rank_mesh,
)
from pbs_tpu_torch.parallel.sharding import (
    gather_tree,
    place_tree,
    quant_aware_shardings,
    sharding_specs,
)

#: Positional spec entry vocabulary: ``None`` (replicated dim), an
#: ``int`` mesh-axis index, or a tuple of indices (multi-axis dim).
SpecEntry = Any

#: The flagship transformer's rule table. Paths are "/"-joined from
#: the ``init_params`` tree; order matters (first match wins). The
#: layout is the Megatron one ``parallel/sharding.param_specs``
#: derives — vocab-sharded embed/head, column-parallel wq/wk/wv/w1/w3,
#: row-parallel wo/w2, replicated norms — restated positionally:
#: ``-1`` = the innermost (tensor) mesh axis.
PARTITION_RULES: tuple[tuple[str, tuple], ...] = (
    (r"^embed$", (-1, None)),
    (r"(^|/)(attn_norm|mlp_norm|final_norm)$", ()),
    (r"/w[qkv]$", (None, None, -1)),
    (r"/wo$", (None, -1, None)),
    (r"/w[13]$", (None, None, -1)),
    (r"/w2$", (None, -1, None)),
    (r"^head$", (None, -1)),
)

#: The canonical flagship param paths the table must cover — the
#: static ``serve-unmatched-rule`` check audits PARTITION_RULES
#: against this literal (dead/shadowed/uncovered detection without
#: importing torch), and tests/test_torch_serve.py pins it against the
#: real ``init_params`` tree so it cannot drift from the model.
TEMPLATE_PATHS: tuple[str, ...] = (
    "embed",
    "layers/attn_norm",
    "layers/wq",
    "layers/wk",
    "layers/wv",
    "layers/wo",
    "layers/mlp_norm",
    "layers/w1",
    "layers/w3",
    "layers/w2",
    "final_norm",
    "head",
)


def _is_quant_leaf(node: Any) -> bool:
    """int8 checkpoint leaf: {"q": int8 weights, "s": scales}
    (models/quant._quantize_leaf) — partitioned as ONE logical leaf."""
    return isinstance(node, dict) and set(node) == {"q", "s"}


def iter_leaf_paths(params: dict, prefix: str = "") -> Iterable[tuple[str, Any]]:
    """(path, leaf) pairs in deterministic key order; quant dicts are
    single logical leaves."""
    for key in sorted(params):
        node = params[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(node, dict) and not _is_quant_leaf(node):
            yield from iter_leaf_paths(node, path)
        else:
            yield path, node


def _leaf_shape(leaf: Any) -> tuple:
    if _is_quant_leaf(leaf):
        return tuple(np.shape(leaf["q"]))
    return tuple(np.shape(leaf))


def match_partition_rules(rules: Iterable[tuple[str, tuple]],
                          params: dict) -> dict:
    """Positional-spec tree for ``params``: scalars (ndim 0 or one
    element) are unpartitioned, the first rule whose regex ``search``es
    the "/"-joined path wins, an unmatched non-scalar leaf raises."""
    rules = tuple(rules)

    def walk(tree: dict, prefix: str) -> dict:
        out = {}
        for key in sorted(tree):
            node = tree[key]
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(node, dict) and not _is_quant_leaf(node):
                out[key] = walk(node, path)
                continue
            shape = _leaf_shape(node)
            if len(shape) == 0 or int(np.prod(shape)) == 1:
                out[key] = ()
                continue
            for pattern, spec in rules:
                if re.search(pattern, path) is not None:
                    out[key] = tuple(spec)
                    break
            else:
                raise ValueError(
                    f"no partition rule matches param {path!r} "
                    f"(shape {shape}); every non-scalar leaf must be "
                    f"covered — extend the rule table, do not rely on "
                    f"silent replication")
        return out

    return walk(params, "")


def audit_rules(rules: Iterable[tuple[str, tuple]],
                paths: Iterable[str] = TEMPLATE_PATHS) -> dict:
    """First-match-wins audit of a rule table against a path universe:
    ``dead`` rules match nothing, ``shadowed`` rules match only paths
    an earlier rule already claimed, ``uncovered`` paths match no rule.
    The runtime twin of the static ``serve-unmatched-rule`` check."""
    rules = tuple(rules)
    paths = tuple(paths)
    claimed: dict[str, int] = {}
    raw_hits: list[set[str]] = [set() for _ in rules]
    for path in paths:
        for i, (pattern, _) in enumerate(rules):
            if re.search(pattern, path) is not None:
                raw_hits[i].add(path)
                if path not in claimed:
                    claimed[path] = i
    dead = [rules[i][0] for i in range(len(rules)) if not raw_hits[i]]
    shadowed = [
        rules[i][0] for i in range(len(rules))
        if raw_hits[i] and all(claimed[p] != i for p in raw_hits[i])
    ]
    uncovered = [p for p in paths if p not in claimed]
    return {"dead": dead, "shadowed": shadowed, "uncovered": uncovered}


def resolve_spec(mesh: Mesh, raw: tuple) -> P:
    """Positional spec -> named :class:`PartitionSpec` for ``mesh``.
    Non-negative indices address ``mesh.axis_names`` directly,
    negatives index Python-style (``-1`` = innermost axis)."""
    names = mesh.axis_names

    def one(entry: SpecEntry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            return tuple(one(e) for e in entry)
        idx = int(entry)
        try:
            return names[idx]
        except IndexError:
            raise ValueError(
                f"positional spec index {idx} out of range for mesh "
                f"axes {names}") from None

    return P(*(one(e) for e in raw))


def rule_shardings(params: dict, mesh: Mesh,
                   rules: Iterable[tuple[str, tuple]] = PARTITION_RULES
                   ) -> dict:
    """NamedSharding tree for ``params``: match rules, resolve the
    positional specs against ``mesh``, and hand placement to the
    quant-aware walk ``parallel/sharding`` already owns."""
    raw = match_partition_rules(rules, params)

    def named(tree):
        if isinstance(tree, dict):
            return {k: named(v) for k, v in tree.items()}
        return resolve_spec(mesh, tree)

    return quant_aware_shardings(named(raw), params, mesh)


def make_shard_and_gather_fns(params: dict, mesh: Mesh,
                              rules: Iterable[tuple[str, tuple]]
                              = PARTITION_RULES
                              ) -> tuple[Callable, Callable]:
    """(shard, gather) tree functions for trees shaped like ``params``.
    ``shard`` cuts a full tree down to this rank's blocks by the rule
    table, on the mesh's device; ``gather`` returns the full
    (host-readable) tree from every rank's blocks — a collective every
    rank calls — the checkpoint save path, and the roundtrip the
    byte-identity test pins."""
    shardings = rule_shardings(params, mesh, rules)
    specs = sharding_specs(shardings)

    def shard(tree: dict) -> dict:
        return place_tree(tree, shardings)

    def gather(tree: dict) -> dict:
        return gather_tree(tree, mesh, specs)

    return shard, gather


def make_serve_mesh(tp: int = 1, dp: int = 1, device: Any = None) -> Mesh:
    """The serving mesh: (dp, tp) with the tensor axis INNERMOST, so
    positional ``-1`` in the rule table lands on it and tp groups sit
    on neighboring ranks. The one place in the serve package that
    spells mesh-axis names (the engine's kv-cache placement contract
    requires a 'tp' axis).

    A 1x1 mesh is this process alone and needs no world; a larger one
    spans every rank of the initialised world, so ``dp * tp`` must be
    the world's size. ``device`` is this rank's device (None means the
    card, and raises without one)."""
    import torch.distributed as dist

    need = int(dp) * int(tp)
    have = dist.get_world_size() if dist.is_initialized() else 1
    axes = {"dp": int(dp), "tp": int(tp)}
    if need == 1 and not dist.is_initialized():
        return one_rank_mesh(tuple(axes), device)
    if need != have:
        raise ValueError(
            f"serve mesh dp={dp} x tp={tp} needs {need} ranks, have "
            f"{have}: a serving mesh spans the whole world")
    return make_mesh(axes, device=device)
