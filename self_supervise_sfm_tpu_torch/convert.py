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
