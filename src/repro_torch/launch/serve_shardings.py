"""Specs for decode caches, dispatched on cache node types.

The port of ``src/repro/launch/serve_shardings.py``. A spec is
``repro_torch.dist.sharding``'s form (one tuple of mesh axes per
dimension) where the reference has a ``NamedSharding``.
"""
from __future__ import annotations

from typing import Any

from repro_torch.dist.sharding import MeshRules, _resolve
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache

PyTree = Any

# Rank-5 KV: (layers, batch, length, kv_heads, head_dim). "kv_seq" is inert
# by default; long-context cells map it to ("data",) so a 512k batch=1
# cache is split along its length instead of replicated.
KV_NAMES = (None, "batch", "kv_seq", "kv_heads", None)
CONV_NAMES = (None, "batch", None, "inner")
STATE_NAMES = (None, "batch", "inner", None, None)


def cache_shardings(caches: PyTree, mr: MeshRules) -> PyTree:
    """The same nest as ``caches`` (``meta`` tensors from
    ``api.abstract_caches``) with each leaf's resolved spec.

    Layer-stacked attention KV: (R, B, L, KV, hd) -> batch, kv_seq,
    kv_heads. SSM conv (R, B, 3, C) -> batch + inner; SSM state
    (R, B, H, P, N) -> batch + inner (on H). Encoder-decoder memory tuples
    hold bare rank-5 leaves and take the KV layout; any other bare leaf
    puts batch on its first dimension.
    """

    def walk(node):
        if isinstance(node, KVCache):
            return KVCache(k=_leaf(node.k, mr), v=_leaf(node.v, mr))
        if isinstance(node, SSMCache):
            return SSMCache(
                conv=_resolve(node.conv.shape, CONV_NAMES, mr),
                state=_resolve(node.state.shape, STATE_NAMES, mr))
        if isinstance(node, (list, tuple)):
            if hasattr(node, "_fields"):  # other named tuples
                return type(node)(*(walk(x) for x in node))
            return type(node)(walk(x) for x in node)
        return _leaf(node, mr)

    return walk(caches)


def _leaf(leaf, mr: MeshRules) -> tuple:
    rank = len(leaf.shape)
    names = KV_NAMES if rank == 5 else ("batch",) + (None,) * (rank - 1)
    return _resolve(leaf.shape, names, mr)
