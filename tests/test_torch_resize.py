"""PyTorch port: bilinear upsample (K3) plain version vs the JAX package.

The plain version of the card's one-pass 4-tap kernel is held against the
Pallas two-pass kernels in interpret mode and the einsum
``resize_bilinear_ac``; the W taps differ from the interp-matrix matmul only
by fp32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.heads import dpt_utils as JDU
from self_supervise_sfm_tpu.ops.resize import resize_bilinear_kernel
from self_supervise_sfm_tpu_torch.heads import dpt_utils as TDU
from self_supervise_sfm_tpu_torch.ops import resize as TRS

torch.set_num_threads(1)

SHAPES = [
    (37, 37, 74, 74, 8),     # DPT x2 pyramid step (scaled channels)
    (74, 74, 130, 130, 8),   # 518/296-style non-integer ratio
    (18, 22, 37, 45, 16),    # non-square, non-integer
    (9, 13, 9, 26, 8),       # W-only upsample
    (7, 16, 21, 16, 8),      # H-only upsample
]
# fp32 taps: the fraction of a source coordinate up to ~130 carries ~1e-5
# absolute rounding, times |x_hi - x_lo| < 10 for unit-normal inputs
ATOL_F32 = 1e-4


def _inputs(rng, h, w, h2, w2, c, with_add):
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    add = rng.normal(size=(h2, w2, c)).astype(np.float32) if with_add else None
    return x, add


@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("h,w,h2,w2,c", SHAPES)
def test_plain_matches_pallas_and_einsum(rng, h, w, h2, w2, c, with_add):
    x, add = _inputs(rng, h, w, h2, w2, c, with_add)
    jadd = None if add is None else jnp.asarray(add)
    j_kernel = resize_bilinear_kernel(
        jnp.asarray(x), (h2, w2), JDU._interp_matrix_ac(w2, w), interpret=True,
        add=jadd,
    )
    j_ref = JDU._resize_einsum(jnp.asarray(x), (h2, w2))
    if add is not None:
        j_ref = j_ref + jadd[None]
    out = TRS.resize_bilinear(
        torch.from_numpy(x), (h2, w2), None if add is None else torch.from_numpy(add))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_kernel), atol=ATOL_F32)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_ref), atol=ATOL_F32)


@pytest.mark.parametrize("h,w,h2,w2,c", SHAPES[:3])
def test_plain_bf16_store_matches_pallas(rng, h, w, h2, w2, c):
    x, add = _inputs(rng, h, w, h2, w2, c, True)
    j = resize_bilinear_kernel(
        jnp.asarray(x), (h2, w2), JDU._interp_matrix_ac(w2, w), interpret=True,
        add=jnp.asarray(add), out_dtype=jnp.bfloat16,
    )
    out = TRS.resize_bilinear(torch.from_numpy(x), (h2, w2), torch.from_numpy(add),
                              torch.bfloat16)
    assert out.dtype == torch.bfloat16
    # at most one bf16 ulp (2^-7 relative) where the fp32 sums straddle a
    # rounding boundary
    np.testing.assert_allclose(out.float().numpy(), np.asarray(j.astype(jnp.float32)),
                               rtol=2.0**-7, atol=ATOL_F32)


@pytest.mark.parametrize("impl", ["auto", "einsum", "kernel"])
@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_resize_bilinear_ac_matches_jax(rng, impl, out_dtype):
    h, w, h2, w2, c = 18, 22, 37, 45, 16
    x, add = _inputs(rng, h, w, h2, w2, c, True)
    jdt = None if out_dtype is None else jnp.bfloat16
    tdt = None if out_dtype is None else torch.bfloat16
    j = JDU.resize_bilinear_ac(jnp.asarray(x), (h2, w2), add=jnp.asarray(add),
                               out_dtype=jdt)
    t = TDU.resize_bilinear_ac(torch.from_numpy(x), (h2, w2), add=torch.from_numpy(add),
                               out_dtype=tdt, impl=impl)
    atol = ATOL_F32 if out_dtype is None else 0.04  # one bf16 ulp at |y| < 8
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)),
                               atol=atol)


def test_gate_admits_only_the_final_upsample():
    assert TRS.resize_kernel_applicable((5, 296, 296, 128), (518, 518))
    assert not TRS.resize_kernel_applicable((5, 148, 148, 256), (296, 296))
    assert not TRS.resize_kernel_applicable((5, 1, 1, 256), (2, 2), min_elems=0)
    assert not TRS.resize_kernel_applicable((5, 8, 8, 256), (4, 4), min_elems=0)
