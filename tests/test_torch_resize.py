"""PyTorch port: bilinear upsample (K3) plain version vs the JAX package.

The plain version of the card's one-pass 4-tap kernel is held against the
Pallas two-pass kernels in interpret mode and the einsum
``resize_bilinear_ac``; the W taps differ from the interp-matrix matmul only
by fp32 rounding. The kernel's thread mapping (``csrc/resize.cu``: a thread
owns one output pixel and 8 channels, 4 where C is no multiple of 8, of
every image, and reads its addend once) is emulated with the plain
version's arithmetic: each output element written once, each addend element
read once, and the result equal to the plain version's bit for bit, which
checks the mapping (the card's fused lerp is held against the plain version
on the card).
"""

import re
from pathlib import Path

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


K3_SOURCE = (Path(__file__).resolve().parents[1] / "self_supervise_sfm_tpu_torch" / "csrc"
             / "resize.cu").read_text()
K3_THREADS = int(re.findall(r"constexpr int THREADS = (\d+);", K3_SOURCE)[0])


def _lerp(a, b, f):
    return a * (1.0 - f) + b * f


def _k3_emulation(x, out_hw, add, out_dtype):
    """resize_bilinear_ac_kernel's mapping: thread idx of the grid owns the
    channels c .. c + 4V of output pixel (j, i), idx = (j W2 + i) groups + c
    / 4V; it reads its addend values once, then walks the images n innermost:
    four taps, two W lerps, the H lerp, the addend, the store. Returns the
    output and the count of writes of each output element and of reads of
    each addend element."""
    N, H, W, C = x.shape
    H2, W2 = out_hw
    V = 2 if C % 8 == 0 else 1
    groups = C // (4 * V)
    lh, fh = TRS._taps(H, H2, "cpu")
    lw, fw = TRS._taps(W, W2, "cpu")
    blocks = -(-H2 * W2 * groups // K3_THREADS)
    idx = torch.arange(blocks * K3_THREADS)
    idx = idx[idx < H2 * W2 * groups]  # the threads past the end return
    c = (idx % groups) * 4 * V
    pix = idx // groups
    i, j = pix % W2, pix // W2
    ch = c[:, None] + torch.arange(4 * V)  # (threads, 4V)
    jj, ii = j[:, None].expand_as(ch), i[:, None].expand_as(ch)
    out = torch.full((N, H2, W2, C), float("nan"), dtype=out_dtype)
    writes = torch.zeros((N, H2, W2, C), dtype=torch.int64)
    reads = torch.zeros((H2, W2, C), dtype=torch.int64)
    if add is not None:
        p = add[jj, ii, ch]
        reads.index_put_((jj, ii, ch), torch.ones_like(ch), accumulate=True)
    r0, r1 = lh[j][:, None], lh[j][:, None] + 1
    c0, c1 = lw[i][:, None], lw[i][:, None] + 1
    f_w, f_h = fw[i][:, None], fh[j][:, None]
    for n in range(N):
        xn = x[n]
        y = _lerp(_lerp(xn[r0, c0, ch], xn[r0, c1, ch], f_w),
                  _lerp(xn[r1, c0, ch], xn[r1, c1, ch], f_w), f_h)
        if add is not None:
            y = y + p
        out[n][jj, ii, ch] = y.to(out_dtype)
        writes[n].index_put_((jj, ii, ch), torch.ones_like(ch), accumulate=True)
    return out, writes, reads


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("c", [24, 12])
def test_kernel_mapping_covers_each_output_once_and_reads_the_addend_once(
        rng, c, with_add, out_dtype):
    """The kernel's thread mapping, not its arithmetic: at a ragged shape (11
    x 13 pixels, 3 images: 429 or 286 threads, no multiple of the block), 8
    channels a thread (C = 24) and 4 (C = 12), every output element is
    written once and every addend element read once a call. The emulation
    computes each value with the plain version's arithmetic, so its output
    equals the plain version's bit for bit exactly when every thread reads
    the right taps and addend element and writes the right output; the
    kernel's fused lerp is held against the plain version on the card
    (phase 2 of ``chip_smoke.py``: 1 bf16 ulp, fp32 within 1e-5 relative)."""
    x, add = _inputs(rng, 5, 7, 11, 13, c, with_add)
    x = np.concatenate([x, x[:1] * 0.5])  # 3 images
    tx = torch.from_numpy(x)
    tadd = None if add is None else torch.from_numpy(add)
    got, writes, reads = _k3_emulation(tx, (11, 13), tadd, out_dtype)
    assert (writes == 1).all()
    assert (reads == (1 if with_add else 0)).all()
    ref = TRS.resize_bilinear_plain(tx, (11, 13), tadd, out_dtype)
    assert got.dtype == ref.dtype == out_dtype
    assert torch.equal(got.view(torch.int16 if out_dtype == torch.bfloat16 else torch.int32),
                       ref.view(torch.int16 if out_dtype == torch.bfloat16 else torch.int32))


def test_kernel_source_follows_the_emulated_mapping():
    """The lines of resize.cu that the emulation mirrors: the index
    decomposition, the addend loaded before the loop over the images, the
    taps and the lerp order, 8 channels where C is a multiple of 8. (The
    card's lerp fuses its second product, fma(b, f, a (1 - f)); the
    emulation's arithmetic is the plain version's, which phase 2 of
    ``chip_smoke.py`` holds the kernel against within 1e-5 relative.)"""
    for line in ("const int c = (int)(idx % groups) * 4 * V;",
                 "const int pix = (int)(idx / groups);",
                 "const int i = pix % W2, j = pix / W2;",
                 "lo = min((j * (n - 1)) / (n2 - 1), n - 2);",
                 "const float g = 1.f - f;",
                 "return __fmaf_rn(b, f, __fmul_rn(a, g));",
                 "y[v] = lerp4(lerp4(__ldg(t00 + v), __ldg(t01 + v), fw),",
                 "lerp4(__ldg(t10 + v), __ldg(t11 + v), fw), fh);",
                 "if (C % 8 == 0)\n    launch<2>"):
        assert line in K3_SOURCE, line
    addend = K3_SOURCE.index("p[v] = add != nullptr ? __ldg(")
    loop = K3_SOURCE.index("for (int n = 0; n < n_img; ++n, base += in_img) {")
    assert addend < loop
    assert K3_SOURCE.count("add + o_pix") == 1
