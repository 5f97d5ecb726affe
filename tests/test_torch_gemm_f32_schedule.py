"""The arithmetic and tile schedule of the fp32 GEMM body (the fp32 forms of
LN+QKV+RoPE, LN+QKV, the out-projection, MLP-up and MLP-down), emulated on
the CPU and held against the JAX Pallas kernels in fp32 and the port's
plain versions; the routes of the fp32 forms on meta tensors.

``csrc/gemm_f32.cu`` runs only on the card. :func:`_product` and the epilogues repeat its
arithmetic in PyTorch with its tile sizes read from the source: the layer
norm pre-pass (lane sums over 4-channel chunks, the warp's butterfly, fp32
statistics, ``((x - mu) * rstd) * w + b`` with one rounding a step); row
tiles of BM rows, zero-filled past M; each output element one FFMA chain
over K in order (the exact product in fp64, rounded to fp32 with the sum);
the out-projection's A gathered from o (B, H, N, d) by the loader's
offsets; the epilogues as the kernel's threads hold them (at head dim 64 a
head's 64 values of a row as 16 lanes of 4: the qk-norm's sums a lane's 4
values in order, then the half-warp's xor butterfly; RoPE's partner 4 lanes
away; at head dim 128 16 lanes of 8, columns 4 l + e and 64 + 4 l + e: a
lane's sum of its first 4 values plus its sum of the other 4, then the
butterfly; RoPE's partner 8 lanes away; erf GELU; ``x + (acc + b) *
gamma``); only rows below M stored, each once.
It is held against ``fused_qkv_kernel`` / ``fused_qkv_plain_kernel`` /
``fused_proj_kernel`` / ``fused_mlp_kernel(..., interpret=True)`` in fp32
(their erf is Abramowitz & Stegun 7.1.26, |err| < 1.5e-7, where the kernel
and the plain version use erf) and the port's plain versions, with the
tolerance phase 2 of ``chip_smoke.py`` applies to the fp32 entries on the
card: 2e-5 of the largest |output| (the fp32 tolerance of the attention
bodies' tests, ``tests/test_torch_flash_f32_schedule.py``).
Rows are ragged (200, 2 x 1374 for LN+QKV: a 128-row tile crosses the frame
boundary; 3 x 200 and 1 x 600 for the out-projection), the eps is the
ViT's and the aggregator's, and one row is all zeros. The head dim 128
kernels (the "d128-" cases) at 2 heads of 128 (C 256) and an odd head count,
3 heads (C 384), with 2 x 200 rows for the tile across a frame boundary.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.ops import fused_qkv as JFQ
from self_supervise_sfm_tpu_torch import _kernels as TK
from self_supervise_sfm_tpu_torch.layers import block as TB
from self_supervise_sfm_tpu_torch.ops import fused_qkv as TFQ

torch.set_num_threads(1)

SOURCE = (Path(TFQ.__file__).resolve().parents[1] / "csrc" / "gemm_f32.cu").read_text()


def _const(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert len(found) == 1, name
    return int(found[0])


BM, BN, BK, HD, TM = (_const(n) for n in ("BM", "BN", "BK", "HD", "TM"))
HD128 = _const("HD128")  # the head dim 128 kernels' template argument
NTHREADS, STAGES = _const("NTHREADS"), _const("STAGES")
LANES = 16  # the threads of a row group: a head's values of a row, 4 (d 64) or 8 (d 128) each
TOL = 2e-5
ENTRIES = ("sfm_ln_qkv_rope_f32", "sfm_ln_qkv_f32", "sfm_proj_residual_f32", "sfm_mlp_up_f32",
           "sfm_mlp_down_f32")
D128_ENTRIES = ("sfm_ln_qkv_rope_d128_f32", "sfm_ln_qkv_d128_f32", "sfm_proj_residual_d128_f32")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.array(x, dtype=np.float32)


def _assert_close(got, ref, what):
    err = float(np.abs(_np(got) - _np(ref)).max())
    tol = TOL * float(np.abs(_np(ref)).max())
    assert err <= tol, f"{what}: max abs error {err} over {tol}"


# -- the kernel's arithmetic ----------------------------------------------------


def _tree(v):
    """The xor butterfly's sum over the last axis (a power of two): every lane
    ends with pairs summed, then pairs of pairs."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _ln_prepass(x, w, b, eps: float):
    """ln_rows_f32_kernel on x (M, K): lane l sums the float4 chunks at 4 l +
    128 s, each as (x0 + x1) + (x2 + x3), then the warp's butterfly; the
    normalisation one rounding a step."""
    M, K = x.shape
    chunks = x.reshape(M, K // 128, 32, 4)
    lane = torch.zeros((M, 32))
    for s in range(K // 128):
        c = chunks[:, s]
        lane = lane + ((c[..., 0] + c[..., 1]) + (c[..., 2] + c[..., 3]))
    mu = _tree(lane)[:, None] / K
    d = (chunks - mu[:, :, None, None]).reshape(M, K // 128, 32, 4)
    lane = torch.zeros((M, 32))
    for s in range(K // 128):
        c = d[:, s] * d[:, s]
        lane = lane + ((c[..., 0] + c[..., 1]) + (c[..., 2] + c[..., 3]))
    rs = torch.rsqrt(_tree(lane)[:, None] / K + eps)
    return ((x - mu) * rs) * w + b


def _product(a, w):
    """fp32 accumulators over the row tiles of ``a`` zero-filled past M: one
    FFMA chain an element, K in order (``a`` and ``w`` fp32)."""
    M, K = a.shape
    assert K % BK == 0 and w.shape[1] % BN == 0
    rows = -(-M // BM) * BM
    a_pad = torch.zeros((rows, K), dtype=torch.float64)
    a_pad[:M] = a.double()
    w64 = w.double()
    acc = torch.zeros((rows, w.shape[1]), dtype=torch.float32)
    for k in range(K):
        acc = (acc.double() + a_pad[:, k:k + 1] * w64[k]).float()
    return acc


def _tiles(acc, M, epilogue, nout):
    """The epilogue of each row tile on its BM rows (those past M computed
    and dropped); the stored rows, each once."""
    out = torch.full((M, nout), float("nan"))
    for m0 in range(0, acc.shape[0], BM):
        vals = epilogue(acc[m0:m0 + BM], m0)
        n = min(BM, M - m0)
        if n > 0:
            assert torch.isnan(out[m0:m0 + n]).all()
            out[m0:m0 + n] = vals[:n]
    assert not torch.isnan(out).any()
    return out


def _lane_sums(t):
    """A lane's sum of its values of a head (..., d) -> (..., 16): lane l
    holds columns 64 j + 4 l + e; ((v0 + v1) + v2) + v3 at each j, the j
    sums added in order (d 128: j = 0 plus j = 1)."""
    g = t.reshape(*t.shape[:-1], t.shape[-1] // 64, LANES, 4)
    part = ((g[..., 0] + g[..., 1]) + g[..., 2]) + g[..., 3]
    total = part[..., 0, :]
    for j in range(1, part.shape[-2]):
        total = total + part[..., j, :]
    return total


def _head_norm(t, w, b, eps: float):
    """The qk-norm on a head's d values of each row: 16 lanes of d / 16, a
    lane's sums in order, then the half-warp's butterfly; one rounding a
    step."""
    d = t.shape[-1]
    mu = _tree(_lane_sums(t))[..., None] / d
    xc = t - mu
    rs = torch.rsqrt(_tree(_lane_sums(xc * xc))[..., None] / d + eps)
    return ((xc * rs) * w) + b


def _rope(t, cos, sin):
    """t * cos + rot * sin, rot = (-t2, t1, -t4, t3) over quarters of d / 4
    columns: the partner of lane l is lane l ^ (d / 16) at the same j (lane
    ^ 4 at d 64, lane ^ 8 at d 128), negated in quarters 1 and 3."""
    d = t.shape[-1]
    x = d // 16
    lanes = t.reshape(*t.shape[:-1], d // 64, LANES, 4)
    partner = lanes[..., [l ^ x for l in range(LANES)], :]
    lower = torch.tensor([l & x == 0 for l in range(LANES)])[:, None]
    rot = torch.where(lower, -partner, partner).reshape(t.shape)
    return t * cos + rot * sin


def _qkv_acc(x, lw, lb, w, eps: float):
    """The pre-pass and the product of LN+QKV(+RoPE), shared by both forms."""
    B, N, C = x.shape
    return _product(_ln_prepass(x.reshape(B * N, C), lw, lb, eps), w)


def _qkv(acc, x, b, heads: int, eps: float, norms=None, cos=None, sin=None, d: int = HD):
    """LN+QKV(+RoPE)'s epilogue on ``acc`` (:func:`_qkv_acc`): x (B, N, C) ->
    q, k, v (B, Hl, N, d) for the Hl = ``heads`` heads of the bias's 3 Hl d
    columns (Hl even at d 64: two heads a 128-column tile; one at d 128)."""
    B, N, C = x.shape
    M, nout = B * N, b.shape[0]
    assert (heads % 2 == 0 or d == HD128) and nout == 3 * heads * d
    rows = torch.arange(acc.shape[0])
    n_of = torch.where(rows < M, rows % N, 0)  # rows past M read token 0's tables

    def epilogue(t, m0):
        v = t + b
        if norms is None:
            return v
        n = n_of[m0:m0 + BM]
        parts = list(v.split(heads * d, dim=1))
        for pi, (nw, nb) in enumerate(norms):
            hv = parts[pi].reshape(-1, heads, d)
            hv = _head_norm(hv, nw, nb, eps)
            parts[pi] = _rope(hv, cos[n][:, None], sin[n][:, None]).reshape(-1, heads * d)
        return torch.cat(parts, dim=1)

    y = _tiles(acc, M, epilogue, nout)
    q, k, v = y.reshape(B, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _gather_o(o):
    """The out-projection's A as the loader reads it: merged row m = (b, n),
    column 16 kt + c at o's flat offset ((b H) N + n) d + (k0 // d) N d + k0
    % d + c, k0 = 16 kt (a K step inside one head at d 64 and 128)."""
    B, H, N, d = o.shape
    m = torch.arange(B * N)
    b, n = m // N, m % N
    k = torch.arange(H * d)
    k0, c = (k // BK) * BK, k % BK
    row_off = (b * H * N + n) * d
    off = row_off[:, None] + ((k0 // d) * N * d + k0 % d + c)[None]
    return o.reshape(-1)[off]


def _proj(o, x, w, b, gamma):
    B, H, N, d = o.shape
    a = _gather_o(o)
    assert torch.equal(a, o.transpose(1, 2).reshape(B * N, H * d))
    acc = _product(a, w)
    x2 = x.reshape(B * N, -1)
    x_pad = torch.zeros((acc.shape[0], x2.shape[1]))
    x_pad[:B * N] = x2
    y = _tiles(acc, B * N, lambda t, m0: x_pad[m0:m0 + BM] + (t + b) * gamma, w.shape[1])
    return y.reshape(B, N, -1)


def _up(x, lw, lb, w1, b1, eps: float):
    acc = _product(_ln_prepass(x, lw, lb, eps), w1)
    c = torch.tensor(2.0**-0.5, dtype=torch.float32)
    return _tiles(acc, x.shape[0],
                  lambda t, m0: (0.5 * (t + b1)) * (1.0 + torch.erf((t + b1) * c)), w1.shape[1])


def _down(h, x, w2, b2, gamma):
    acc = _product(h, w2)
    x_pad = torch.zeros((acc.shape[0], x.shape[1]))
    x_pad[:x.shape[0]] = x
    return _tiles(acc, x.shape[0], lambda t, m0: x_pad[m0:m0 + BM] + (t + b2) * gamma,
                  w2.shape[1])


# -- cases ------------------------------------------------------------------------

C, CH = 256, 512  # the pre-pass takes C in steps of 256; 4 column tiles of MLP-up
HEADS = C // HD
ZERO_ROW = 137


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _pair(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a.copy())


MLP_CASES = {"200_vit_eps": (200, 1e-6), "200_agg_eps": (200, 1e-5), "1374_agg_eps": (1374, 1e-5)}


@pytest.fixture(scope="module")
def mlp_cases():
    out = {}
    for name, (M, eps) in MLP_CASES.items():
        rng = np.random.default_rng(M + int(eps * 1e7))
        x = _f32(rng, 1, M, C)
        x[0, ZERO_ROW] = 0.0
        (jx, tx), (jw1, tw1), (jw2, tw2) = (_pair(a) for a in (
            x, _f32(rng, C, CH, scale=C**-0.5), _f32(rng, CH, C, scale=CH**-0.5)))
        host = dict(lw=1 + _f32(rng, C, scale=0.1), lb=_f32(rng, C, scale=0.1),
                    b1=_f32(rng, CH, scale=0.1), b2=_f32(rng, C, scale=0.1),
                    gm=_f32(rng, C, scale=0.1))
        t = {k: torch.from_numpy(v) for k, v in host.items()}
        j = {k: jnp.asarray(v) for k, v in host.items()}
        h = _up(tx[0], t["lw"], t["lb"], tw1, t["b1"], eps)
        y = _down(h, tx[0], tw2, t["b2"], t["gm"])
        jargs = (jx, j["lw"], j["lb"], jw1, j["b1"], jw2, j["b2"], j["gm"])
        out[name] = dict(
            h=h, y=y, hn=_ln_prepass(tx[0], t["lw"], t["lb"], eps), lb=t["lb"],
            plain_h=TFQ.fused_mlp_up_plain(tx, t["lw"], t["lb"], tw1, t["b1"], eps)[0],
            plain_y=TFQ.fused_mlp_down_plain(h[None], tx, tw2, t["b2"], t["gm"])[0],
            pallas=JFQ.fused_mlp_kernel(*jargs, eps=eps, block_n=128, interpret=True)[0],
            plain=TFQ.fused_mlp_residual_plain(tx, t["lw"], t["lb"], tw1, t["b1"], tw2,
                                               t["b2"], t["gm"], eps)[0])
    return out


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_up_f32_emulation_matches_plain(mlp_cases, case):
    c = mlp_cases[case]
    _assert_close(c["h"], c["plain_h"], f"MLP-up fp32 {case}")


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_down_f32_emulation_matches_plain(mlp_cases, case):
    c = mlp_cases[case]
    _assert_close(c["y"], c["plain_y"], f"MLP-down fp32 {case}")


@pytest.mark.parametrize("ref", ["pallas", "plain"])
@pytest.mark.parametrize("case", list(MLP_CASES))
def test_mlp_f32_emulation_matches(mlp_cases, case, ref):
    """The two kernels in a row against the Pallas pair in interpret mode in
    fp32 and the port's plain chain."""
    c = mlp_cases[case]
    _assert_close(c["y"], c[ref], f"MLP fp32 {case} vs {ref}")


def test_f32_zero_row_normalises_to_the_bias(mlp_cases):
    """A row of zeros: rstd = 1 / sqrt(eps) multiplies zeros, so the pre-pass
    writes the norm's bias, bit for bit, and the outputs are finite."""
    for name, c in mlp_cases.items():
        assert torch.equal(c["hn"][ZERO_ROW], c["lb"]), name
        assert torch.isfinite(c["h"][ZERO_ROW]).all() and torch.isfinite(c["y"][ZERO_ROW]).all()


# name -> (B, N, eps, C, head dim): at head dim 64 C = 256 (4 heads); at 128
# 2 heads (C 256) and an odd head count, 3 heads (C 384)
QKV_CASES = {"1x200_vit_eps": (1, 200, 1e-6, C, HD), "1x200_agg_eps": (1, 200, 1e-5, C, HD),
             "2x1374_agg_eps": (2, 1374, 1e-5, C, HD),
             "d128-1x200_vit_eps": (1, 200, 1e-6, C, HD128),
             "d128-2x200_agg_eps": (2, 200, 1e-5, C, HD128),
             "d128-3heads-1x200_agg_eps": (1, 200, 1e-5, 384, HD128)}


@pytest.fixture(scope="module")
def qkv_cases():
    out = {}
    for name, (B, N, eps, Cq, d) in QKV_CASES.items():
        heads = Cq // d
        rng = np.random.default_rng(B * N + int(eps * 1e7) + (Cq if d == HD128 else 0))
        x = _f32(rng, B, N, Cq)
        x[0, ZERO_ROW] = 0.0
        (jx, tx), (jw, tw) = _pair(x), _pair(_f32(rng, Cq, 3 * Cq, scale=Cq**-0.5))
        ang = rng.uniform(-np.pi, np.pi, size=(N, d))
        host = dict(lw=1 + _f32(rng, Cq, scale=0.1), lb=_f32(rng, Cq, scale=0.1),
                    b=_f32(rng, 3 * Cq, scale=0.1), qw=1 + _f32(rng, d, scale=0.1),
                    qb=_f32(rng, d, scale=0.1), kw=1 + _f32(rng, d, scale=0.1),
                    kb=_f32(rng, d, scale=0.1), cos=np.cos(ang).astype(np.float32),
                    sin=np.sin(ang).astype(np.float32))
        t = {k: torch.from_numpy(v) for k, v in host.items()}
        j = {k: jnp.asarray(v) for k, v in host.items()}
        norms = ((t["qw"], t["qb"]), (t["kw"], t["kb"]))
        jrope = (jx, j["lw"], j["lb"], jw, j["b"], j["qw"], j["qb"], j["kw"], j["kb"], j["cos"],
                 j["sin"], heads)
        jplain = (jx, j["lw"], j["lb"], jw, j["b"], heads)
        trope = (tx, t["lw"], t["lb"], tw, t["b"], t["qw"], t["qb"], t["kw"], t["kb"], t["cos"],
                 t["sin"], heads, eps)
        acc = _qkv_acc(tx, t["lw"], t["lb"], tw, eps)
        out[name] = dict(
            rope=dict(emulation=_qkv(acc, tx, t["b"], heads, eps, norms, t["cos"], t["sin"], d),
                      plain=TFQ.fused_ln_qkv_rope_plain(*trope),
                      pallas=JFQ.fused_qkv_kernel(*jrope, eps=eps, block_n=128, interpret=True)),
            plain=dict(emulation=_qkv(acc, tx, t["b"], heads, eps, d=d),
                       plain=TFQ.fused_ln_qkv_plain(tx, t["lw"], t["lb"], tw, t["b"], heads, eps),
                       pallas=JFQ.fused_qkv_plain_kernel(*jplain, eps=eps, block_n=128,
                                                         interpret=True)))
    return out


@pytest.mark.parametrize("ref", ["plain", "pallas"])
@pytest.mark.parametrize("kernel", ["rope", "plain"])
@pytest.mark.parametrize("case", list(QKV_CASES))
def test_qkv_f32_emulation_matches(qkv_cases, case, kernel, ref):
    """The emulated LN+QKV(+RoPE) against the port's plain version and the
    Pallas kernel in interpret mode in fp32, each of q, k and v within 2e-5
    of its largest |value|; every output (B, H, N, d) and finite at the zero
    row."""
    c = qkv_cases[case][kernel]
    for label, g, r in zip("qkv", c["emulation"], c[ref]):
        assert g.shape == tuple(r.shape)
        assert torch.isfinite(g[0, :, ZERO_ROW]).all()
        _assert_close(g, r, f"LN+QKV {kernel} fp32 {case} {label} vs {ref}")


# name -> (B, H, N, head dim)
PROJ_CASES = {"3x200_2heads": (3, 2, 200, HD), "1x600_4heads": (1, 4, 600, HD),
              "d128-3x200_2heads": (3, 2, 200, HD128), "d128-1x300_3heads": (1, 3, 300, HD128)}


@pytest.fixture(scope="module")
def proj_cases():
    out = {}
    for name, (B, H, N, d) in PROJ_CASES.items():
        Cp = H * d
        rng = np.random.default_rng(B * 1000 + N + (d if d == HD128 else 0))
        (jo, to), (jx, tx), (jw, tw) = (_pair(a) for a in (
            _f32(rng, B, H, N, d), _f32(rng, B, N, Cp), _f32(rng, Cp, Cp, scale=Cp**-0.5)))
        b, gm = _f32(rng, Cp, scale=0.1), _f32(rng, Cp)
        tb, tg = torch.from_numpy(b), torch.from_numpy(gm)
        jargs = (jo, jx, jw, jnp.asarray(b), jnp.asarray(gm))
        out[name] = dict(
            emulation=_proj(to, tx, tw, tb, tg),
            plain=TFQ.fused_proj_residual_plain(to, tx, tw, tb, tg),
            pallas=JFQ.fused_proj_kernel(*jargs, block_n=128, interpret=True))
    return out


@pytest.mark.parametrize("ref", ["plain", "pallas"])
@pytest.mark.parametrize("case", list(PROJ_CASES))
def test_proj_f32_emulation_matches(proj_cases, case, ref):
    """The emulated out-projection (rows of o gathered frame by frame, row
    tiles across frame boundaries) against the port's plain version and the
    Pallas kernel in interpret mode in fp32."""
    c = proj_cases[case]
    _assert_close(c["emulation"], c[ref], f"out-proj fp32 {case} vs {ref}")


def test_the_ffma_chain_moves_the_sum_within_the_tolerance():
    """Summing K in order, one rounding a multiply-add, is another order than
    one fp32 matmul: the results differ, within the tolerance."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_f32(rng, 300, 1024))
    w = torch.from_numpy(_f32(rng, 1024, 128, scale=1024**-0.5))
    got, one = _product(a, w)[:300], torch.matmul(a, w)
    assert not torch.equal(got, one)
    _assert_close(got, one, "FFMA chain vs one matmul")


# -- the source ---------------------------------------------------------------------


def _c_params(entry: str) -> list:
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', SOURCE)
    assert m, entry
    return [p.strip() for p in m.group(1).split(",")]


def test_f32_source_entries_and_signatures():
    """The five entries, the head dim 128 forms of the first three, the
    pre-pass alone and the info entry are in the source and in
    ``_kernels._SIGNATURES`` with one argtype a parameter (pointers and the
    stream ``c_void_p``, ints ``c_int``, eps ``c_float``), and take the
    arguments of their bf16 forms (``sfm_*_d128_sm90`` at head dim 128)."""
    for entry in ENTRIES + D128_ENTRIES + ("sfm_ln_rows_f32", "sfm_gemm_f32_info"):
        params = _c_params(entry)
        sig = TK._SIGNATURES[entry]
        assert len(sig) == len(params), entry
        for p, t in zip(params, sig):
            want = (TK._P if "*" in p else TK._F if p.startswith("float ") else TK._I)
            assert t is want, (entry, p)
        bf16 = entry.replace("_f32", "_sm90").replace("ln_rows_sm90", "ln_rows_bf16")
        if bf16 in TK._SIGNATURES and entry != "sfm_gemm_f32_info":
            assert TK._SIGNATURES[bf16] == sig, entry
    for kernel in ("ln_qkv_rope_f32_kernel", "ln_qkv_f32_kernel", "proj_residual_f32_kernel",
                   "mlp_up_f32_kernel", "mlp_down_f32_kernel"):
        assert f"SFM_GEMM_F32_KERNEL({kernel}, " in SOURCE
    for kernel, ep in (("ln_qkv_rope", "E_QKV_ROPE"), ("ln_qkv", "E_QKV"),
                       ("proj_residual", "E_PROJ")):
        assert f"SFM_GEMM_F32_KERNEL_HD({kernel}_d128_f32_kernel, {ep}, HD128)" in SOURCE
        assert f"case D128 + {ep}: return {kernel}_d128_f32_kernel;" in SOURCE
    assert "__global__ void __launch_bounds__(LN_ROWS * 32)\nln_rows_f32_kernel(" in SOURCE


def test_f32_constants_and_thread_layout():
    """The tile the emulation assumes: 128 x 128 tiles of 256 threads, an 8 x
    8 register tile each (rows 8 ty + i, columns 4 tx + e and 64 + 4 tx + e),
    so that a head's 64 values of a row lie in the 16 lanes of a half-warp,
    and at head dim 128 the tile's one head's 128 values of a row too (8 a
    lane: RoPE's partner 32 columns away, 8 lanes); K steps of 16 through the
    stages' cp.async copies (A rows tid / 4 and tid / 4 + 64, W rows tid /
    32 and tid / 32 + 8: each stage's floats once). The head dims are the
    body's template arguments, and the wrappers' table holds the same."""
    assert (BM, BN, BK, NTHREADS, TM) == (128, 128, 16, 256, 8)
    assert (HD, HD128) == (64, 128) and TFQ.HEAD_DIMS == (HD, HD128)
    assert BN // HD == 2 and BN // HD128 == 1  # heads a column tile
    for line in ("template <int EP, int HD>\n__device__ __forceinline__ void gemm(",
                 "constexpr int which = (HD == HD128 ? D128 : 0) + EP;",
                 "if constexpr (HD == HD128 && (EP == E_QKV_ROPE || EP == E_QKV)) {",
                 "store_qkv_d128<EP>(p, val, m0 + ty * TM + i, n0, tx);",
                 "half_warp_sum(__fadd_rn(sum4(val, 0), sum4(val, 4))) / "
                 "static_cast<float>(HD128);",
                 "const float partner = __shfl_xor_sync(0xffffffffu, val[4 * j + e], 8);",
                 "const bool lower = ((tx >> 3) & 1) == 0;",
                 "*reinterpret_cast<float4*>(dst + 64) = "
                 "make_float4(val[4], val[5], val[6], val[7]);",
                 "heads % (BN / HD) || dim <= 0)"):
        assert line in SOURCE, line
    assert NTHREADS == (BM // TM) * (BN // 8) and LANES == 16
    assert "constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE) * 4;" in SOURCE
    assert STAGES * (BM * BK + BK * BN) * 4 <= 48 * 1024 * 2
    for line in ("const int ty = tid >> 4, tx = tid & 15;",
                 "const int row = m0 + ty * TM + i;",
                 "const int col = n0 + 64 * j + 4 * tx;",
                 "const float partner = __shfl_xor_sync(0xffffffffu, val[e], 4);",
                 "const bool lower = ((tx >> 2) & 1) == 0;",
                 "for (int off = 1; off < 16; off <<= 1) "
                 "v += __shfl_xor_sync(0xffffffffu, v, off);",
                 "a_off[i] = (b * p.heads * p.ntok + n) * HD + ach;",
                 "const int ka = EP == E_PROJ ? (k0 / HD) * p.ntok * HD + k0 % HD : k0;",
                 "a_off[i] >= 0 ? p.a + (a_off[i] + ka) : p.a, a_off[i] >= 0 ? 16 : 0);",
                 "if (static_cast<long long>(p.M) * p.K >= big || "
                 "static_cast<long long>(p.K) * p.nout >= big ||",
                 "acc[i][0] = fmaf(x, b0.x, acc[i][0]);"):
        assert line in SOURCE, line
    # every A and W float of a stage copied exactly once by the 256 threads
    a_cells = sorted(((tid >> 2) + 64 * i, (tid & 3) * 4) for tid in range(NTHREADS)
                     for i in range(2))
    assert a_cells == sorted((r, c) for r in range(BM) for c in range(0, BK, 4))
    b_cells = sorted(((tid >> 5) + 8 * i, (tid & 31) * 4) for tid in range(NTHREADS)
                     for i in range(2))
    assert b_cells == sorted((r, c) for r in range(BK) for c in range(0, BN, 4))
    # every output of the tile owned by one thread; a head's 64 columns of a
    # row by the 16 threads of one half-warp
    owned = sorted((8 * (tid >> 4) + i, 64 * j + 4 * (tid & 15) + e) for tid in range(NTHREADS)
                   for i in range(TM) for j in range(2) for e in range(4))
    assert owned == sorted((r, c) for r in range(BM) for c in range(BN))
    for tid in range(NTHREADS):
        assert (tid & 31) >> 4 == (tid >> 4) & 1  # lanes 0-15 / 16-31: one row group each


# -- the routes (meta tensors: the card's checks, no build) -------------------------

N = 1374  # a 518 px frame's tokens
FLASH_F32, FLASH = "sfm_flash_fwd_f32", "sfm_flash_fwd_bf16"


@pytest.fixture
def launches(monkeypatch):
    seen = []
    monkeypatch.setattr(TK, "launch", lambda name, *args: seen.append((name, args)))
    monkeypatch.setattr(TK, "stream_ptr", lambda t: 0)
    return seen


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _block(C, heads, form, mode, dtype, w_dtype=None):
    cfg = TB.BlockConfig(dim=C, num_heads=heads, qk_norm=form == "frame", fused_qkv=mode,
                         fused_mlp=mode)
    p = TB.init_block(None, "meta", cfg)
    for sub in (p["attn"]["qkv"], p["attn"]["proj"], p["mlp"]["fc1"], p["mlp"]["fc2"]):
        sub["w"] = sub["w"].to(w_dtype or dtype)
    x = _meta(2, N, C, dtype=dtype)
    rope = (_meta(N, C // heads), _meta(N, C // heads)) if form == "frame" else None
    return lambda: TB.block(p, x, cfg, rope)


@pytest.mark.parametrize("form", ["frame", "vit"])
@pytest.mark.parametrize("mode,dtype,want", [
    ("on", torch.float32, ["sfm_ln_qkv_rope_f32", FLASH_F32, "sfm_proj_residual_f32",
                           "sfm_mlp_up_f32", "sfm_mlp_down_f32"]),
    ("auto", torch.float32, [FLASH_F32]),
    ("on", torch.bfloat16, ["sfm_ln_qkv_rope_sm90", FLASH, "sfm_proj_residual_sm90",
                            "sfm_mlp_up_sm90", "sfm_mlp_down_sm90"]),
    ("auto", torch.bfloat16, ["sfm_ln_qkv_rope_sm90", FLASH, "sfm_proj_residual_sm90",
                              "sfm_mlp_up_sm90", "sfm_mlp_down_sm90"]),
])
def test_block_routes_by_dtype(launches, form, mode, dtype, want):
    """A block at the main path's width (C 1024, 16 heads) on the card's
    route: fp32 "on" launches the five ``*_f32`` entries (the ViT block
    LN+QKV's), fp32 "auto" none of them (the unfused chain, as JAX's), bf16
    the ``*_sm90`` entries as before; the output keeps x's dtype."""
    out = _block(1024, 16, form, mode, dtype)()
    if form == "vit":
        want = [n.replace("ln_qkv_rope", "ln_qkv") for n in want]
    assert [name for name, _ in launches] == want
    assert out.shape == (2, N, 1024) and out.dtype == dtype


def test_f32_launches_count_apart(launches):
    """An fp32 launch counts in ``.launches_f32``, a bf16 one in ``.launches``."""
    wrappers = (TFQ.fused_ln_qkv_rope_fwd, TFQ.fused_proj_residual_fwd, TFQ.fused_mlp_up,
                TFQ.fused_mlp_down)
    before = [(w.launches, w.launches_f32) for w in wrappers]
    _block(1024, 16, "frame", "on", torch.float32)()
    assert [(w.launches, w.launches_f32) for w in wrappers] == [(a, b + 1) for a, b in before]
    _block(1024, 16, "frame", "on", torch.bfloat16)()
    assert [(w.launches, w.launches_f32) for w in wrappers] == [(a + 1, b + 1)
                                                                for a, b in before]


@pytest.mark.parametrize("x_dtype,w_dtype", [(torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
def test_mixed_dtypes_raise(launches, x_dtype, w_dtype):
    """Activations and weights of two dtypes: each wrapper raises, at the
    first kernel of the block, and launches nothing."""
    with pytest.raises(TypeError, match="the kernel takes"):
        _block(1024, 16, "frame", "on", x_dtype, w_dtype)()
    C, Ch = 1024, 4096
    x, w = _meta(2, 8, C, dtype=x_dtype), _meta(C, Ch, dtype=w_dtype)
    with pytest.raises(TypeError, match="the kernel takes"):
        TFQ.fused_mlp_up(x, _meta(C), _meta(C), w, _meta(Ch))
    with pytest.raises(TypeError, match="the kernel takes"):
        TFQ.fused_mlp_down(_meta(2, 8, Ch, dtype=x_dtype), x, _meta(Ch, C, dtype=w_dtype),
                           _meta(C), _meta(C))
    with pytest.raises(TypeError, match="the kernel takes"):
        TFQ.fused_proj_residual_fwd(_meta(2, 16, 8, 64, dtype=x_dtype), x,
                                    _meta(C, C, dtype=w_dtype), _meta(C), _meta(C))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        TFQ.fused_mlp_up(x.half(), _meta(C), _meta(C), w.half(), _meta(Ch))
    assert launches == []


@pytest.mark.parametrize("C,heads", [(1024, 4), (1024, 32), (320, 5)])
def test_f32_on_meets_the_refusal_of_widths(launches, C, heads):
    """fp32 "on" at a width the kernels refuse raises, as bf16 "on" does:
    head dim 256, 32, an odd head count of 64."""
    with pytest.raises(ValueError, match="head dim 64|even head count"):
        _block(C, heads, "frame", "on", torch.float32)()
    assert launches == []


@pytest.mark.parametrize("rope", [True, False])
def test_head_shard_reaches_the_f32_entries(launches, rope):
    """One rank's head shard under tensor parallelism, the (1024, 3 Hl 64)
    weight at Hl = 8: the fp32 wrappers take it and launch the fp32 entry
    with Hl heads, as the bf16 ones do; q, k, v are (B, Hl, N, 64)."""
    C, hl = 1024, 8
    nout = 3 * hl * HD
    x, w = _meta(2, N, C), _meta(C, nout)
    if rope:
        out = TFQ.fused_ln_qkv_rope_fwd(x, _meta(C), _meta(C), w, _meta(nout), _meta(HD),
                                        _meta(HD), _meta(HD), _meta(HD), _meta(N, HD),
                                        _meta(N, HD), hl)
    else:
        out = TFQ.fused_ln_qkv_fwd(x, _meta(C), _meta(C), w, _meta(nout), hl)
    (name, args), = launches
    assert name == ("sfm_ln_qkv_rope_f32" if rope else "sfm_ln_qkv_f32")
    assert args[-6:-2] == (2, N, C, hl)
    assert all(t.shape == (2, hl, N, HD) and t.dtype == torch.float32 for t in out)
    # and through a block's qkv weight: qkv_parts reads Hl off the weight
    cfg = TB.BlockConfig(dim=C, num_heads=16, qk_norm=rope, fused_qkv="on")
    p = {"norm1": {"scale": _meta(C), "bias": _meta(C)},
         "attn": {"qkv": {"w": w, "b": _meta(nout)},
                  "q_norm": {"scale": _meta(HD), "bias": _meta(HD)},
                  "k_norm": {"scale": _meta(HD), "bias": _meta(HD)}}}
    TB.qkv_parts(p, x, cfg, (_meta(N, HD), _meta(N, HD)) if rope else None)
    assert launches[-1][0] == name and launches[-1][1][-6:-2] == (2, N, C, hl)


D128_F32 = ["sfm_ln_qkv_rope_d128_f32", "sfm_flash_fwd_d128_f32", "sfm_proj_residual_d128_f32",
            "sfm_mlp_up_f32", "sfm_mlp_down_f32"]


@pytest.mark.parametrize("form", ["frame", "vit"])
@pytest.mark.parametrize("mode,want", [("on", D128_F32), ("auto", ["sfm_flash_fwd_d128_f32"])])
def test_f32_d128_block_routes(launches, form, mode, want):
    """The fp32 model of 8 heads of 128 at C 1024: "on" takes the head dim
    128 forms of LN+QKV(+RoPE) and the out-projection (the ViT block
    LN+QKV's) beside K1's and the MLP pair's fp32 entries; "auto" takes no
    fused block (the unfused chain, as JAX's), K1 alone."""
    out = _block(1024, 8, form, mode, torch.float32)()
    if form == "vit":
        want = [n.replace("ln_qkv_rope", "ln_qkv") for n in want]
    assert [name for name, _ in launches] == want
    assert out.shape == (2, N, 1024) and out.dtype == torch.float32


def test_f32_d128_launches_count_apart(launches):
    """An fp32 launch at head dim 128 counts in ``.launches_d128_f32`` and in
    no other counter of its wrapper."""
    wrappers = (TFQ.fused_ln_qkv_rope_fwd, TFQ.fused_ln_qkv_fwd, TFQ.fused_proj_residual_fwd)
    attrs = ("launches", "launches_f32", "launches_d128", "launches_d128_f32")

    def counts():
        return [tuple(getattr(w, a) for a in attrs) for w in wrappers]

    before = counts()
    _block(1024, 8, "frame", "on", torch.float32)()
    _block(1024, 8, "vit", "on", torch.float32)()
    want = [(a, b, c, d + n) for (a, b, c, d), n in zip(before, (1, 1, 2))]
    assert counts() == want


@pytest.mark.parametrize("rope", [True, False])
def test_head_shard_reaches_the_f32_d128_entries(launches, rope):
    """One rank's head shard at head dim 128, the (1024, 3 Hl 128) weight at
    Hl = 4 of 8: the fp32 wrappers launch the head dim 128 entry with Hl
    heads; q, k, v are (B, Hl, N, 128)."""
    C, hl, d = 1024, 4, HD128
    nout = 3 * hl * d
    x, w = _meta(2, N, C), _meta(C, nout)
    if rope:
        out = TFQ.fused_ln_qkv_rope_fwd(x, _meta(C), _meta(C), w, _meta(nout), _meta(d),
                                        _meta(d), _meta(d), _meta(d), _meta(N, d),
                                        _meta(N, d), hl)
    else:
        out = TFQ.fused_ln_qkv_fwd(x, _meta(C), _meta(C), w, _meta(nout), hl)
    (name, args), = launches
    assert name == ("sfm_ln_qkv_rope_d128_f32" if rope else "sfm_ln_qkv_d128_f32")
    assert args[-6:-2] == (2, N, C, hl)
    assert all(t.shape == (2, hl, N, d) and t.dtype == torch.float32 for t in out)


def test_f32_wrappers_on_cpu_are_the_plain_versions():
    """On a CPU tensor an fp32 wrapper runs its plain version and counts no
    launch, bf16 or fp32."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_f32(rng, 2, 9, C))
    lw, lb = torch.ones(C), torch.zeros(C)
    w1, b1 = torch.from_numpy(_f32(rng, C, CH, scale=C**-0.5)), torch.zeros(CH)
    n0 = (TFQ.fused_mlp_up.launches, TFQ.fused_mlp_up.launches_f32)
    h = TFQ.fused_mlp_up(x, lw, lb, w1, b1)
    assert torch.equal(h, TFQ.fused_mlp_up_plain(x, lw, lb, w1, b1)) and h.dtype == torch.float32
    assert (TFQ.fused_mlp_up.launches, TFQ.fused_mlp_up.launches_f32) == n0
