"""SwiGLU feed-forward (the DINOv2 giant backbones' FFN variant).

Port of ``self_supervise_sfm_tpu/layers/swiglu.py``. No shipped
configuration uses it (the ViT-L of the main path has the plain MLP); it is
kept for the layer inventory.
"""

from __future__ import annotations

import torch.nn.functional as F

from . import params as P


def swiglu_hidden_fused(hidden_features: int) -> int:
    """SwiGLUFFNFused hidden sizing: (2/3 h + 7) // 8 * 8."""
    return (int(hidden_features * 2 / 3) + 7) // 8 * 8


def init_swiglu(g, device, d_in: int, hidden: int, d_out=None, bias: bool = True):
    d_out = d_out or d_in
    return {
        "w12": P.init_linear(g, device, d_in, 2 * hidden, bias=bias),
        "w3": P.init_linear(g, device, hidden, d_out, bias=bias),
    }


def swiglu(p, x):
    x1, x2 = P.linear(p["w12"], x).chunk(2, dim=-1)
    return P.linear(p["w3"], F.silu(x1) * x2)
