"""Convert a parameter tree of the JAX package into the port's params.

The input is the JAX ``init_sailrecon`` pytree with every leaf already a
numpy array (nested dicts and lists; no JAX types). The conversion:

- unstacks depth-stacked block leaves into per-layer lists (the
  aggregator's frame/global/reloc blocks, the ViT blocks and the camera
  trunk);
- maps 4-D conv weights from HWIO ``(kh, kw, in, out)`` to PyTorch's OIHW,
  and transposed-conv weights from ``(kh, kw, out, in)`` to PyTorch's
  ``(in, out, kh, kw)`` — the same permutation (3, 2, 0, 1) for both;
- keeps every other leaf's layout (linear weights stay ``(d_in, d_out)``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# keys of the depth-stacked block stacks (the aggregator's three stacks, the
# ViT blocks, the camera trunk)
_STACKED = frozenset({"frame_blocks", "global_blocks", "reloc_blocks", "blocks", "trunk"})


def _leaf(key, a):
    t = torch.from_numpy(np.array(a))
    if key == "w" and t.dim() == 4:
        t = t.permute(3, 2, 0, 1).contiguous()
    return t


def _convert(node, key=None):
    if isinstance(node, dict):
        return {
            k: ([_convert(_index(v, i)) for i in range(_depth(v))]
                if k in _STACKED else _convert(v, k))
            for k, v in node.items()
        }
    if isinstance(node, (list, tuple)):
        return [_convert(v, key) for v in node]
    if node is None:
        return None
    return _leaf(key, node)


def _depth(tree) -> int:
    if isinstance(tree, dict):
        return _depth(next(iter(tree.values())))
    return np.asarray(tree).shape[0]


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def from_jax_params(tree_of_numpy: Any):
    """JAX ``init_sailrecon`` params (numpy leaves) -> the port's params, as
    CPU tensors."""
    return _convert(tree_of_numpy)


def cache_from_jax(cache_numpy, dtype: torch.dtype = torch.float32,
                   num_heads: int = None):
    """A scene cache of the JAX package (numpy leaves) -> the port's
    ``{"kv": (depth, B, heads, N, 2 * head_dim)}`` CPU tensor in ``dtype``.

    Reads the three layouts the JAX package writes: ``"kv2"`` (``{"kv"}``,
    taken as is), ``"heads"`` (``{"k", "v"}`` of (depth, B, heads, N,
    head_dim), concatenated on the last axis) and ``"packed"`` (``{"k", "v"}``
    of (depth, B, N, C), un-merged to heads first; needs ``num_heads``). A
    bfloat16 leaf goes through float32, which holds every bfloat16 exactly.
    """

    def leaf(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    if "kv" in cache_numpy:
        return {"kv": leaf(cache_numpy["kv"]).to(dtype)}
    k, v = leaf(cache_numpy["k"]), leaf(cache_numpy["v"])
    if k.dim() == 4:
        if not num_heads or k.shape[-1] % num_heads:
            raise ValueError("a packed cache needs num_heads dividing its width")
        depth, B, N, C = k.shape
        k, v = (t.reshape(depth, B, N, num_heads, C // num_heads).transpose(2, 3)
                for t in (k, v))
    return {"kv": torch.cat([k, v], dim=-1).to(dtype)}
