"""The arithmetic and tile schedule of the Hopper GEMM body (LN+QKV+RoPE,
LN+QKV, the out-projection, MLP-up, MLP-down), emulated on the CPU and held
against the JAX Pallas kernels, the JAX reference chains and the port's
plain versions.

``csrc/gemm_sm90.cu`` runs only on the card. :func:`_qkv`, :func:`_proj`,
:func:`_up` and :func:`_down` repeat its arithmetic in PyTorch: the layer-norm pre-pass
(fp32 statistics, centred variance, the rows rounded to bf16 before the
product), fp32 accumulation over K slices of BK = 64 in order, and the
epilogues' rounding points (``rb(rb(acc) + rb(b))``; then for q and k of
LN+QKV+RoPE a layer norm over each head's 64 values in fp32 rounded to
bf16, and RoPE with bf16 cos / sin, each product rounded; for MLP-up the erf
GELU in fp32; ``rb(x + rb(v * rb(gamma)))``). They are held against
``fused_qkv_kernel`` / ``fused_qkv_plain_kernel`` / ``fused_mlp_kernel(...,
interpret=True)`` and ``reference_qkv`` / ``reference_qkv_plain`` /
``reference_mlp`` of the JAX package and against the port's plain versions,
with the tolerance phase 2 of ``chip_smoke.py`` applies on the card: 2 bf16
ulps at the largest output, 4 for q and k of LN+QKV+RoPE. Rows are ragged
(200 and 1374, no multiple of 128; 2 x 1374 for LN+QKV, so that a tile
crosses a frame boundary), the eps is the ViT's and the aggregator's, and
one row is all zeros. The out-projection's A operand is gathered box by
box by the kernel's 3-D rule (slice kt of the row tile at row r0 of frame f
is the box (0, r0, f H + kt) of o, zeros past N), its rows walked frame by
frame, at 3 frames of 200 rows and one frame of 600. The QKV epilogue's index mapping on the wgmma
accumulator layout (a quad holds one head's row, RoPE's partner is in the
same thread) and the persistent tile walk (tile -> row tile, column tile in
raster groups; a block's tiles shared out between its two consumer
warpgroups; the ring positions and the ping-pong turns) are mirrored in
Python, with their constants read from the source; the walk must cover
every output tile exactly once at the main path's four site shapes. Each
variant of ``tools/ablate_gemm_sm90.py`` must patch the shipped source.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.ops import fused_qkv as JFQ
from self_supervise_sfm_tpu_torch.ops import fused_qkv as TFQ
from self_supervise_sfm_tpu_torch.tools import ablate_gemm_sm90 as ABL

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "self_supervise_sfm_tpu_torch" / "csrc"
SOURCE = (CSRC / "gemm_sm90.cu").read_text()
COMMON = (CSRC / "sm90_common.cuh").read_text()


def _const(name: str) -> str:
    found = re.findall(rf"constexpr \w+ {name} = ([^;]+);", SOURCE)
    assert len(found) == 1, name
    return found[0]


BK, BN, WG_M = int(_const("BK")), int(_const("BN")), int(_const("WG_M"))
GROUP_M, STAGES, HD = int(_const("GROUP_M")), int(_const("STAGES")), int(_const("HD"))
PINGPONG = _const("PINGPONG") == "true"
SMS = 132  # multiprocessors of an H100 SXM: the persistent grid's size
# frames and rows a frame of the main path's sites, their rows (B * N) and
# the MLP widths
SITE_SHAPES = {"vit": (5, 1374), "frame": (10, 1374), "reloc": (5, 1374), "global": (1, 6870)}
SITE_ROWS = {site: b * n for site, (b, n) in SITE_SHAPES.items()}
C_FULL, CH_FULL = 1024, 4096
# (K, output columns) of each kernel of the body at full width
WIDTHS = {"up": (C_FULL, CH_FULL), "down": (CH_FULL, C_FULL), "qkv_rope": (C_FULL, 3 * C_FULL),
          "qkv": (C_FULL, 3 * C_FULL), "proj": (C_FULL, C_FULL)}
bf16 = torch.bfloat16


def _rb(t: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 -> fp32: the value a bf16 tensor would hold."""
    return t.to(bf16).float()


def _ulps(ref, n: int) -> float:
    """n bf16 ulps at the largest |ref|."""
    return n * 2.0 ** (math.floor(math.log2(float(np.abs(_np(ref)).max()))) - 7)


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.array(x.astype(jnp.float32))


def _assert_close(got, ref, tol, what):
    err = float(np.abs(_np(got).reshape(-1) - _np(ref).reshape(-1)).max())
    assert err <= tol, f"{what}: max abs error {err} over {tol}"


# -- the kernel's arithmetic ----------------------------------------------------


def _ln_prepass(x, w, b, eps: float):
    """ln_rows_kernel: mean, centred variance, ((x - mu) * rstd) * w + b in
    fp32, rounded to bf16."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    rs = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return ((xc * rs) * w + b).to(bf16)


def _product(a, w):
    """fp32 accumulators summed over K slices of BK in the kernel's order."""
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], BK):
        acc = acc + torch.matmul(a[:, k0:k0 + BK].float(), w[k0:k0 + BK].float())
    return acc


def _up(x, lw, lb, w1, b1, eps: float):
    """MLP-up: pre-pass, product, rb(rb(acc) + rb(b1)), erf GELU in fp32."""
    h = _rb(_rb(_product(_ln_prepass(x, lw, lb, eps), w1)) + _rb(b1))
    return (0.5 * h * (1.0 + torch.erf(h * torch.tensor(2.0**-0.5)))).to(bf16)


def _down(h, x, w2, b2, gamma):
    """MLP-down: rb(x + rb(rb(rb(acc) + rb(b2)) * rb(gamma)))."""
    v = _rb(_rb(_product(h, w2)) + _rb(b2))
    return (x.float() + _rb(v * _rb(gamma))).to(bf16)


# -- cases: ragged rows, both eps, one row of zeros ---------------------------

C, CH = 256, 512  # the pre-pass takes C in steps of 256; 4 column tiles of MLP-up
CASES = {"200_vit_eps": (200, 1e-6), "200_agg_eps": (200, 1e-5), "1374_agg_eps": (1374, 1e-5)}
ZERO_ROW = 137


def _pair(a: np.ndarray):
    """The same bf16 values for JAX and for PyTorch."""
    j = jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(bf16)


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, (M, eps) in CASES.items():
        rng = np.random.default_rng(M + int(eps * 1e7))
        x = rng.normal(size=(1, M, C))
        x[0, ZERO_ROW] = 0.0
        jx, tx = _pair(x)
        # weights bf16-exact (the kernels take bf16 weights); norm, bias and
        # layer-scale fp32
        jw1, tw1 = _pair(rng.normal(scale=C**-0.5, size=(C, CH)))
        jw2, tw2 = _pair(rng.normal(scale=CH**-0.5, size=(CH, C)))
        f32 = [rng.normal(size=n).astype(np.float32) for n in (C, C, CH, C, C)]
        lw, lb, b1, b2, gm = (1 + 0.1 * f32[0], 0.1 * f32[1], 0.1 * f32[2], 0.1 * f32[3],
                              0.1 * f32[4])
        t = {k: torch.from_numpy(v) for k, v in
             dict(lw=lw, lb=lb, b1=b1, b2=b2, gm=gm).items()}
        x2 = tx[0]
        h = _up(x2, t["lw"], t["lb"], tw1, t["b1"], eps)
        y = _down(h, x2, tw2, t["b2"], t["gm"])
        jargs = (jx, jnp.asarray(lw), jnp.asarray(lb), jw1.astype(jnp.float32),
                 jnp.asarray(b1), jw2.astype(jnp.float32), jnp.asarray(b2), jnp.asarray(gm))
        out[name] = dict(
            x=x2, h=h, y=y, eps=eps,
            hn=_ln_prepass(x2, t["lw"], t["lb"], eps), lb=t["lb"],
            plain_h=TFQ.fused_mlp_up_plain(tx, t["lw"], t["lb"], tw1, t["b1"], eps)[0],
            # the plain down on the emulated hidden: the two halves apart
            plain_y=TFQ.fused_mlp_down_plain(h[None], tx, tw2, t["b2"], t["gm"])[0],
            pallas=JFQ.fused_mlp_kernel(*jargs, eps=eps, block_n=128, interpret=True)[0],
            reference=JFQ.reference_mlp(*jargs, eps=eps)[0],
        )
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_up_emulation_matches_plain(cases, case):
    c = cases[case]
    _assert_close(c["h"], c["plain_h"], _ulps(c["plain_h"], 2), f"MLP-up {case}")


@pytest.mark.parametrize("case", list(CASES))
def test_down_emulation_matches_plain(cases, case):
    c = cases[case]
    _assert_close(c["y"], c["plain_y"], _ulps(c["plain_y"], 2), f"MLP-down {case}")


@pytest.mark.parametrize("ref", ["pallas", "reference"])
@pytest.mark.parametrize("case", list(CASES))
def test_mlp_emulation_matches_jax(cases, case, ref):
    """The two kernels in a row against the JAX Pallas pair in interpret
    mode and the JAX reference chain."""
    c = cases[case]
    _assert_close(c["y"], c[ref], _ulps(c[ref], 2), f"MLP {case} vs {ref}")


def test_zero_row_normalises_to_the_bias(cases):
    """A row of zeros has variance 0: rstd = 1 / sqrt(eps) multiplies zeros,
    so the pre-pass writes the norm's bias, and the row's outputs are finite."""
    for name, c in cases.items():
        assert torch.equal(c["hn"][ZERO_ROW], c["lb"].to(bf16)), name
        assert torch.isfinite(c["h"][ZERO_ROW].float()).all()
        assert torch.isfinite(c["y"][ZERO_ROW].float()).all()


def test_k_slices_move_the_sum_within_the_tolerance(cases):
    """Summing K in slices of 64 is another order than one fp32 matmul: the
    rounded results may differ, within the tolerance."""
    c = cases["1374_agg_eps"]
    x = c["x"]
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(scale=C**-0.5, size=(C, CH)).astype(np.float32)).to(bf16)
    one = torch.matmul(x.float(), w.float()).to(bf16)
    sliced = _product(x, w).to(bf16)
    _assert_close(sliced, one, _ulps(one, 2), "sliced vs one product")


# -- LN+QKV(+RoPE) ---------------------------------------------------------------


def _qkv(x, lw, lb, w, b, heads: int, eps: float, norms=None, cos=None, sin=None):
    """LN+QKV(+RoPE): x (B, N, C) -> q, k, v (B, H, N, d), d = 64 or 128 (w
    is (C, 3 H d)). Pre-pass, product, rb(rb(acc) + rb(b)); with norms
    ((qn_w, qn_b), (kn_w, kn_b)) q and k get ((t - mu) * rstd) * w + b over
    each head in fp32, rounded to bf16, then rb(rb(t * rb(cos)) + rb(rot *
    rb(sin))), rot = (-t2, t1, -t4, t3) over quarters of d."""
    B, N, C = x.shape
    d = w.shape[1] // (3 * heads)
    hn = _ln_prepass(x.reshape(B * N, C), lw, lb, eps)
    y = _rb(_rb(_product(hn, w)) + _rb(b))
    q, k, v = y.reshape(B, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    if norms is not None:
        c, s_ = _rb(cos), _rb(sin)
        out = []
        for t, (nw, nb) in zip((q, k), norms):
            mu = t.mean(-1, keepdim=True)
            tc = t - mu
            rs = torch.rsqrt((tc * tc).mean(-1, keepdim=True) + eps)
            t = _rb((tc * rs) * nw + nb)
            t1, t2, t3, t4 = t.chunk(4, dim=-1)
            rot = torch.cat([-t2, t1, -t4, t3], dim=-1)
            out.append(_rb(_rb(t * c) + _rb(rot * s_)))
        q, k = out
    return tuple(t.to(bf16) for t in (q, k, v))


# (B, N, eps, d): 200 rows in one frame, and two frames of 1374 (a 128-row
# tile crosses the frame boundary at row 1374); at head dim 128 the 256
# channels are 2 heads, one a 128-column tile
QKV_CASES = {"1x200_vit_eps": (1, 200, 1e-6, 64), "1x200_agg_eps": (1, 200, 1e-5, 64),
             "2x1374_agg_eps": (2, 1374, 1e-5, 64), "2x1374_agg_eps_d128": (2, 1374, 1e-5, 128)}
QKV_HEADS = C // HD  # 4 heads of 64: 3C = 768, six 128-column tiles, two a part


@pytest.fixture(scope="module")
def qkv_cases():
    out = {}
    for name, (B, N, eps, d) in QKV_CASES.items():
        heads = C // d
        rng = np.random.default_rng(B * N + int(eps * 1e7) + d)
        x = rng.normal(size=(B, N, C))
        x[0, ZERO_ROW] = 0.0
        jx, tx = _pair(x)
        jw, tw = _pair(rng.normal(scale=C**-0.5, size=(C, 3 * C)))
        f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
        lw, lb, b = 1 + 0.1 * f32(C), 0.1 * f32(C), 0.1 * f32(3 * C)
        qw, qb, kw, kb = 1 + 0.1 * f32(d), 0.1 * f32(d), 1 + 0.1 * f32(d), 0.1 * f32(d)
        ang = rng.uniform(-np.pi, np.pi, size=(N, d))
        cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
        t = {k: torch.from_numpy(v) for k, v in dict(
            lw=lw, lb=lb, b=b, qw=qw, qb=qb, kw=kw, kb=kb, cos=cos, sin=sin).items()}
        norms = ((t["qw"], t["qb"]), (t["kw"], t["kb"]))
        j = {k: jnp.asarray(v) for k, v in dict(
            lw=lw, lb=lb, b=b, qw=qw, qb=qb, kw=kw, kb=kb, cos=cos, sin=sin).items()}
        jrope = (jx, j["lw"], j["lb"], jw.astype(jnp.float32), j["b"], j["qw"], j["qb"], j["kw"],
                 j["kb"], j["cos"], j["sin"], heads)
        jplain = (jx, j["lw"], j["lb"], jw.astype(jnp.float32), j["b"], heads)
        trope = (tx, t["lw"], t["lb"], tw, t["b"], t["qw"], t["qb"], t["kw"], t["kb"], t["cos"],
                 t["sin"], heads, eps)
        out[name] = dict(
            eps=eps, x=tx, lw=t["lw"], lb=t["lb"], heads=heads, d=d,
            rope=dict(emulation=_qkv(tx, t["lw"], t["lb"], tw, t["b"], heads, eps, norms,
                                     t["cos"], t["sin"]),
                      plain=TFQ.fused_ln_qkv_rope_plain(*trope),
                      pallas=JFQ.fused_qkv_kernel(*jrope, eps=eps, block_n=128, interpret=True),
                      reference=JFQ.reference_qkv(*jrope, eps=eps)),
            plain=dict(emulation=_qkv(tx, t["lw"], t["lb"], tw, t["b"], heads, eps),
                       plain=TFQ.fused_ln_qkv_plain(tx, t["lw"], t["lb"], tw, t["b"], heads,
                                                    eps),
                       pallas=JFQ.fused_qkv_plain_kernel(*jplain, eps=eps, block_n=128,
                                                         interpret=True),
                       reference=JFQ.reference_qkv_plain(*jplain, eps=eps)),
        )
    return out


def _assert_qkv(got, ref, kernel: str, what: str):
    """q, k within 4 ulps of their largest value for LN+QKV+RoPE, v (and all
    three of LN+QKV) within 2, as phase 2 on the card."""
    for label, g, r in zip("qkv", got, ref):
        n = 4 if kernel == "rope" and label != "v" else 2
        _assert_close(g, r, _ulps(r, n), f"{what} {label}")


@pytest.mark.parametrize("ref", ["plain", "pallas", "reference"])
@pytest.mark.parametrize("kernel", ["rope", "plain"])
@pytest.mark.parametrize("case", list(QKV_CASES))
def test_qkv_emulation_matches(qkv_cases, case, kernel, ref):
    """The emulated LN+QKV(+RoPE) against the port's plain version, the Pallas
    kernel in interpret mode and the JAX reference chain."""
    c = qkv_cases[case][kernel]
    _assert_qkv(c["emulation"], c[ref], kernel, f"LN+QKV {kernel} {case} vs {ref}")


def test_qkv_zero_row_and_shapes(qkv_cases):
    """The zero row normalises to the norm's bias in the pre-pass and gives
    finite q, k, v; every output is (B, H, N, d)."""
    for name, c in qkv_cases.items():
        B, N, _ = c["x"].shape
        hn = _ln_prepass(c["x"][0], c["lw"], c["lb"], c["eps"])
        assert torch.equal(hn[ZERO_ROW], c["lb"].to(bf16)), name
        for kernel in ("rope", "plain"):
            for t in c[kernel]["emulation"]:
                assert t.shape == (B, c["heads"], N, c["d"])
                assert torch.isfinite(t[0, :, ZERO_ROW].float()).all()


# -- the out-projection ------------------------------------------------------------


def _proj(o, x, w, b, gamma, bm: int = WG_M):
    """The out-projection as the kernel computes it: x (B, N, C) + layer-scale
    of merge_heads(o (B, H, N, d)) @ w + b. Row tiles of ``bm`` rows walked
    frame by frame; K slice kt of the tile at row r0 of frame f is the box
    (64 (kt % a), r0, f H + kt // a) of o seen as (d, N, B H), a = d / 64
    slices a head, zeros past N; fp32
    accumulators summed over the slices in order; the residual epilogue
    rb(x + rb(rb(rb(acc) + rb(b)) * rb(gamma))); rows past N not stored.
    Every stored row is written once (the output starts as NaN)."""
    B, H, N, d = o.shape
    C = H * d
    slices = o.reshape(B * H, N, d)
    x2 = x.reshape(B * N, C)
    y = torch.full((B * N, C), float("nan"), dtype=bf16)
    a = d // BK
    for f in range(B):
        for r0 in range(0, N, bm):
            acc = torch.zeros((bm, C), dtype=torch.float32)
            for kt in range(C // BK):
                box = torch.zeros((bm, BK), dtype=bf16)
                c0 = BK * (kt % a)
                rows = slices[f * H + kt // a, r0:r0 + bm, c0:c0 + BK]
                box[:rows.shape[0]] = rows
                acc = acc + torch.matmul(box.float(), w[kt * BK:(kt + 1) * BK].float())
            v = _rb(_rb(acc) + _rb(b))
            m0, n = f * N + r0, min(bm, N - r0)
            assert torch.isnan(y[m0:m0 + n].float()).all()
            y[m0:m0 + n] = (x2[m0:m0 + n].float() + _rb(v[:n] * _rb(gamma))).to(bf16)
    assert not torch.isnan(y.float()).any()
    return y.reshape(B, N, C)


# (B, H, N, d): three frames of 200 rows (two tiles each, the second
# ragged), one frame of 600 rows (five tiles) with four heads (four K
# slices); at head dim 128 two K slices a head
PROJ_CASES = {"3x200_2heads": (3, 2, 200, 64), "1x600_4heads": (1, 4, 600, 64),
              "3x200_2heads_d128": (3, 2, 200, 128)}


@pytest.fixture(scope="module")
def proj_cases():
    out = {}
    for name, (B, H, N, d) in PROJ_CASES.items():
        C = H * d
        rng = np.random.default_rng(B * 1000 + N + d)
        jo, to = _pair(rng.normal(size=(B, H, N, d)))
        jx, tx = _pair(rng.normal(size=(B, N, C)))
        jw, tw = _pair(rng.normal(scale=C**-0.5, size=(C, C)))
        b, gm = (0.1 * rng.normal(size=C)).astype(np.float32), rng.normal(size=C).astype(
            np.float32)
        tb, tg = torch.from_numpy(b), torch.from_numpy(gm)
        jargs = (jo, jx, jw.astype(jnp.float32), jnp.asarray(b), jnp.asarray(gm))
        out[name] = dict(
            emulation=_proj(to, tx, tw, tb, tg),
            plain=TFQ.fused_proj_residual_plain(to, tx, tw, tb, tg),
            pallas=JFQ.fused_proj_kernel(*jargs, block_n=128, interpret=True),
            reference=JFQ.reference_proj(*jargs),
        )
    return out


@pytest.mark.parametrize("ref", ["plain", "pallas", "reference"])
@pytest.mark.parametrize("case", list(PROJ_CASES))
def test_proj_emulation_matches(proj_cases, case, ref):
    """The emulated out-projection (3-D boxes, the walk frame by frame)
    against the port's plain version, the Pallas kernel in interpret mode and
    the JAX reference chain, within phase 2's 2 ulps."""
    c = proj_cases[case]
    _assert_close(c["emulation"], c[ref], _ulps(c[ref], 2), f"out-proj {case} vs {ref}")


def _proj_boxes(B: int, N: int, H: int, bm: int = WG_M, d: int = HD):
    """(row tile, frame, r0, the K slices' box coordinates, the stored flat
    rows of each consumer part) of every row tile, as the producer and the
    consumers of gemm_sm90.cu compute them for E_PROJ: at head dim 64 slice
    kt is head kt, at 128 channels 64 (kt % 2) of head kt / 2."""
    frame_tiles = -(-N // bm)
    a = d // BK
    out = []
    for mt in range(B * frame_tiles):
        f = mt // frame_tiles
        r0 = (mt - f * frame_tiles) * bm
        boxes = [(BK * (kt % a), r0, f * H + kt // a) for kt in range(H * a)]
        m_end = (f + 1) * N
        parts = []
        for part in range(bm // WG_M):
            m0 = f * N + r0 + part * WG_M
            parts.append(range(m0, max(m0, min(m0 + WG_M, m_end))))
        out.append((mt, f, r0, boxes, parts))
    return out


def test_proj_source_follows_the_3d_rule():
    """The lines of the source that the emulation and the walk mirror."""
    for line in ("tma_load_3d(sa, ma, full, 0, r0, f * p.heads + kt);",
                 "tma_load_3d(sa, ma, full, BK * (kt % (HD / BK)), r0, f * p.heads + kt / (HD / BK));",
                 "const int f = mt / p.frame_tiles, r0 = (mt - f * p.frame_tiles) * BM, "
                 "n0 = nt * BN;",
                 "const int f = mt / p.frame_tiles, m_end = (f + 1) * p.frame_rows;",
                 "const int m0 = f * p.frame_rows + (mt - f * p.frame_tiles) * BM +",
                 "if (row >= m_end) continue;",
                 "const int frames = EP == E_PROJ ? p.batch : 1;",
                 "p.frame_rows = p.M / frames;",
                 "p.frame_tiles = (p.frame_rows + BM - 1) / BM;",
                 "p.m_tiles = frames * p.frame_tiles;",
                 "encode_rows64(&ma, a, 3, p.ntok, HD * 2, p.batch * p.heads, 1, 0, BM, HD)",
                 "SFM_GEMM_KERNEL(proj_residual_sm90_kernel, E_PROJ)",
                 "SFM_GEMM_KERNEL_HD(proj_residual_d128_sm90_kernel, E_PROJ, HD128)"):
        assert line in SOURCE, line
    # the shared encoder: dims (d, N, B H), strides a row and a slice, box
    # (64, BM, 1), rows past N zero-filled
    for line in ("const cuuint64_t dims[4] = {width, n, slices, layers};",
                 "const cuuint64_t strides[3] = {row_bytes, n * row_bytes, layer_bytes};",
                 "const cuuint32_t box[4] = {64, box_rows, 1, 1};",
                 "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE"):
        assert line in COMMON, line


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("pingpong", [True, False])
@pytest.mark.parametrize("site", list(SITE_SHAPES))
def test_proj_boxes_stay_in_their_frame(site, pingpong, d):
    """At the main path's four sites (16 heads of 64, or 8 of 128), for the
    shipped ping-pong tiles and the cooperative variant's 256 rows: no box
    starts at a negative row or past its frame's rows, each box reads one
    head of its own frame (at head dim 128 both 64-channel halves of each
    head, in order), and the stored rows of the parts cover every row once,
    each row in the frame of its tile."""
    B, N = SITE_SHAPES[site]
    H = C_FULL // d
    a = d // BK
    bm = WG_M if pingpong else 2 * WG_M
    stored = []
    for mt, f, r0, boxes, parts in _proj_boxes(B, N, H, bm, d):
        assert 0 <= r0 < N and r0 % bm == 0
        assert len(boxes) == C_FULL // BK
        for kt, (c0, c1, c2) in enumerate(boxes):
            assert (c0, c1) == (BK * (kt % a), r0) and c2 == f * H + kt // a
            assert f * H <= c2 < (f + 1) * H
        for rows in parts:
            assert all(f * N <= r < (f + 1) * N for r in rows)
            stored += list(rows)
    assert sorted(stored) == list(range(B * N))


def test_proj_tiles_and_rounds():
    """The out-projection's tiles and rounds of 132 multiprocessors as the
    source's header quotes them: 11 row tiles a frame of 1374 rows."""
    tiles = {s: b * -(-n // WG_M) * (C_FULL // BN) for s, (b, n) in SITE_SHAPES.items()}
    assert tiles == {"vit": 440, "frame": 880, "reloc": 440, "global": 432}
    assert [round(tiles[s] / SMS, 2) for s in ("vit", "frame", "global")] == [3.33, 6.67, 3.27]
    assert "440 / 880 / 432 tiles" in SOURCE and "3.33 / 6.67 / 3.27 rounds" in SOURCE


@pytest.mark.parametrize("heads,d,match", [(3, 64, "multiple of 128"), (4, 96, "head dim 64"),
                                           (32, 32, "head dim 64")])
def test_proj_wrapper_refuses_widths_the_body_does_not_take(heads, d, match):
    """Off the CPU the out-projection wrapper refuses what the TMA body does
    not take: a head dim other than 64 or 128 (a head is one or two K
    slices), C no multiple of 128 (the output tiles)."""
    C = heads * d
    with pytest.raises(ValueError, match=match):
        TFQ.fused_proj_residual_fwd(_meta(2, heads, 8, d, dtype=bf16), _meta(2, 8, C, dtype=bf16),
                                    _meta(C, C, dtype=bf16), _meta(C), _meta(C))


# -- the QKV epilogue's index mapping ---------------------------------------------


def _owned(warp: int, g: int, t: int):
    """acc[h][4j + e] of thread (warp, g, t) of a consumer warpgroup -> (row,
    column) of its 128 x 128 part: row h * 64 + 16 warp + g (+ 8 for e >= 2),
    column 8j + 2t + (e & 1)."""
    return {(h, 4 * j + e): (h * 64 + 16 * warp + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1))
            for h in range(2) for j in range(BN // 8) for e in range(4)}


@pytest.mark.parametrize("hd", [64, 128])
def test_qkv_epilogue_index_mapping(hd):
    """Every cell of a part is one thread's; a quad's values of one (h, hr,
    hh) are exactly one row of head hh's hd columns (the qk-norm's sum): two
    heads a 128-column part at head dim 64, one at 128; the RoPE partner of
    a value of the first and third quarters, nt + QT, is its column + hd / 4
    (16 or 32) in the same row and thread, in the next quarter, and the pair
    turns with rot's signs."""
    for line in ("const int row = m0 + h * 64 + warp * 16 + hr * 8 + g;",
                 "constexpr int HPT = BN / HD;",
                 "constexpr int NT = HD / 8;",
                 "constexpr int QT = NT / 4;",
                 "const int j = NT * hh + nt;",
                 "v[hh][nt][0] = rb(rb(acc[h][4 * j + 2 * hr]) + rb(bias.x));",
                 "if (nt & QT) continue;  // the pair's second",
                 "const int pn = nt + QT;",
                 "v[hh][nt][0] = rb(__fmul_rn(a0, c1.x)) + rb(__fmul_rn(-b0, s1.x));",
                 "v[hh][pn][0] = rb(__fmul_rn(b0, c2.x)) + rb(__fmul_rn(a0, s2.x));",
                 "SFM_GEMM_KERNEL_HD(ln_qkv_rope_d128_sm90_kernel, E_QKV_ROPE, HD128)",
                 "SFM_GEMM_KERNEL_HD(ln_qkv_d128_sm90_kernel, E_QKV, HD128)"):
        assert line in SOURCE, line
    assert (BN, WG_M, HD) == (128, 128, 64) and BN == 2 * HD
    assert int(_const("HD128")) == 128 == BN
    hpt, nt_, qt = BN // hd, hd // 8, hd // 32
    cells = {}
    for warp in range(4):
        for g in range(8):
            for t in range(4):
                for key, cell in _owned(warp, g, t).items():
                    assert cell not in cells
                    cells[cell] = (warp, g, t, key)
    assert len(cells) == WG_M * BN
    for warp in range(4):
        for g in range(8):
            for h in range(2):
                for hr in range(2):
                    for hh in range(hpt):
                        quad = set()
                        for t in range(4):
                            own = _owned(warp, g, t)
                            for nt in range(nt_):
                                for e in range(2):
                                    j = nt_ * hh + nt
                                    row, col = own[(h, 4 * j + 2 * hr + e)]
                                    assert row == h * 64 + warp * 16 + hr * 8 + g
                                    quad.add((row, col))
                                    if nt & qt:
                                        continue  # the pair's second
                                    pn = nt + qt
                                    prow, pcol = own[(h, 4 * (nt_ * hh + pn) + 2 * hr + e)]
                                    assert prow == row
                                    assert pcol == col + hd // 4
                                    # rot = (-t2, t1, -t4, t3): the first of a
                                    # pair in quarter 1 or 3, its partner next
                                    quarter = (col - hd * hh) // (hd // 4)
                                    assert quarter in (0, 2)
                                    assert (pcol - hd * hh) // (hd // 4) == quarter + 1
                        rows = {r for r, _ in quad}
                        assert len(rows) == 1
                        assert sorted(c for _, c in quad) == list(range(hd * hh, hd * hh + hd))


# -- the persistent tile walk ---------------------------------------------------


def _tile_coords(t: int, m_tiles: int, n_tiles: int, group: int = GROUP_M):
    """tile_coords: raster groups of `group` row tiles, column by column."""
    per_group = group * n_tiles
    first = (t // per_group) * group
    rows = min(m_tiles - first, group)
    r = t % per_group
    return first + r % rows, r // rows


def _walk(M: int, nout: int, pingpong: bool = PINGPONG, group: int = GROUP_M, frames: int = 1):
    """(block, warpgroup, block-local index i, row tile, column tile) of every
    tile a launch computes, as the consumers walk them. The row tiles of
    each of ``frames`` frames of M / frames rows (the out-projection's B
    frames; the other kernels' one)."""
    bm = WG_M if pingpong else 2 * WG_M
    m_tiles, n_tiles = frames * -(-(M // frames) // bm), nout // BN
    tiles = m_tiles * n_tiles
    grid = min(tiles, SMS)
    out = []
    for block in range(grid):
        for cw in (0, 1):
            i = cw if pingpong else 0
            while block + i * grid < tiles:
                out.append((block, cw, i, *_tile_coords(block + i * grid, m_tiles, n_tiles,
                                                        group)))
                i += 2 if pingpong else 1
    return out, m_tiles, n_tiles, grid


@pytest.mark.parametrize("kernel", ["up", "down", "qkv_rope", "qkv", "proj"])
@pytest.mark.parametrize("site", list(SITE_ROWS))
def test_tile_walk_covers_every_tile_once(site, kernel):
    M = SITE_ROWS[site]
    nout = WIDTHS[kernel][1]
    # the out-projection walks its rows frame by frame
    frames = SITE_SHAPES[site][0] if kernel == "proj" else 1
    if kernel.startswith("qkv"):
        # a tile's 128 columns lie in one of q, k, v: two heads
        assert all(nt * BN // C_FULL == ((nt + 1) * BN - 1) // C_FULL
                   for nt in range(nout // BN))
    for pingpong in (True, False):
        for group in sorted({GROUP_M, 1, 8}):
            walk, m_tiles, n_tiles, _ = _walk(M, nout, pingpong, group, frames)
            owners = {}
            for block, cw, i, mt, nt in walk:
                owners.setdefault((mt, nt), set()).add((block, i))
                assert 0 <= mt < m_tiles and 0 <= nt < n_tiles
            # every output tile, each by one (block, tile) only
            assert len(owners) == m_tiles * n_tiles
            assert all(len(v) == 1 for v in owners.values())
            # ping-pong: each tile by one warpgroup; cooperative: by both
            count = {}
            for block, cw, i, mt, nt in walk:
                count[(mt, nt)] = count.get((mt, nt), 0) + 1
            assert set(count.values()) == {1 if pingpong else 2}


@pytest.mark.parametrize("kernel", ["up", "down", "qkv_rope", "qkv", "proj"])
def test_ring_positions_and_turns(kernel):
    """The producer fills the ring tile after tile, K slice after K slice;
    a consumer starts the block's tile i at ring position i * k_tiles, i.e.
    stage (i k) % STAGES of phase (i k / STAGES) & 1. The ping-pong turns:
    the block's tile i is issued in warpgroup i % 2's turn, passed on only
    when tile i + 1 exists, so every arrival on a named barrier meets one
    wait. At the main path's four sites (the out-projection's 16 K slices
    with its row tiles walked frame by frame)."""
    K, nout = WIDTHS[kernel]
    k_tiles = K // BK
    if kernel == "proj":
        assert k_tiles == 16
        for B, N in sorted(set(SITE_SHAPES.values())):
            _check_ring(B * N, nout, k_tiles, B)
        return
    for M in sorted(set(SITE_ROWS.values())):
        _check_ring(M, nout, k_tiles)


def _check_ring(M: int, nout: int, k_tiles: int, frames: int = 1) -> None:
    walk, _, _, grid = _walk(M, nout, True, frames=frames)
    for block in range(grid):
        mine = sorted(i for b, _, i, _, _ in walk if b == block)
        # the producer's (stage, phase) for each slice, in its order
        seq = [(n % STAGES, (n // STAGES) & 1) for n in range(len(mine) * k_tiles)]
        for i in mine:
            it0 = i * k_tiles
            assert (it0 % STAGES, (it0 // STAGES) & 1) == seq[it0]
        # turns: warpgroup 0 arrives on barrier 1 once before it starts
        arrivals, waits = {1: 1, 2: 0}, {1: 0, 2: 0}
        for i in mine:
            cw = i % 2
            waits[1 + cw] += 1
            if i + 1 < len(mine):
                arrivals[2 - cw] += 1
        assert arrivals == waits


def test_constants_and_rounds():
    """The source's constants, its shared memory, and the rounds of 132
    multiprocessors its header quotes for 128 x 128 tiles."""
    assert (BK, BN, WG_M) == (64, 128, 128)
    bm = WG_M if PINGPONG else 2 * WG_M
    stage = bm * BK * 2 + BK * BN * 2
    assert 1024 + STAGES * stage + 2 * STAGES * 8 <= 232448
    rounds = {(site, n): -(-SITE_ROWS[site] // WG_M) * (n // BN) / SMS
              for site in ("vit", "frame") for n in (CH_FULL, C_FULL)}
    assert [round(rounds[k], 1) for k in (("vit", CH_FULL), ("frame", CH_FULL),
                                         ("vit", C_FULL), ("frame", C_FULL))] == [
        13.1, 26.2, 3.3, 6.5]
    assert "13.1 / 26.2 and 3.3 / 6.5 rounds" in SOURCE


def test_qkv_rounds_and_shared_memory():
    """LN+QKV(+RoPE)'s tiles and rounds as the source's header quotes them,
    and their shared memory: the ring and barriers of the MLP pair, nothing
    more (their stores go from the accumulators), launched and reported as
    one size for every kernel of the body."""
    tiles = {s: -(-SITE_ROWS[s] // WG_M) * (3 * C_FULL // BN) for s in ("vit", "frame")}
    assert tiles == {"vit": 1296, "frame": 2592}
    assert [round(tiles[s] / SMS, 1) for s in ("vit", "frame")] == [9.8, 19.6]
    assert "1296 / 2592 tiles" in SOURCE and "9.8 / 19.6" in SOURCE
    assert _const("SMEM_BYTES") == "1024 + BAR_OFF + 2 * STAGES * 8"
    assert "kernel<<<grid, NTHREADS, SMEM_BYTES, " in SOURCE
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES)" in SOURCE
    assert "out[2] = which == 3 ? 0 : SMEM_BYTES;" in SOURCE


@pytest.mark.parametrize("variant", list(ABL.VARIANTS))
def test_ablation_variants_patch_the_shipped_source(variant):
    """Every variant of tools/ablate_gemm_sm90.py finds each text it patches
    exactly once in the shipped source (the tool checks this on the card too,
    before any build), and changes the source unless it is the source."""
    src = ABL.patched_sources({variant: ABL.VARIANTS[variant]})[variant]
    assert (src == SOURCE) == (variant == "as shipped")


def _meta(*shape, dtype=torch.float32):
    """A tensor on no device: the wrappers check it as they check a CUDA
    tensor, and raise before anything is built."""
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("kernel", ["rope", "plain"])
@pytest.mark.parametrize("C,heads,match", [(448, 7, "even head count"),
                                           (1024, 4, "head dim 64"),
                                           (1024, 32, "head dim 64")])
def test_qkv_wrappers_refuse_widths_the_body_does_not_take(kernel, C, heads, match):
    """Off the CPU the LN+QKV wrappers refuse what the TMA body does not take:
    a head dim other than 64 or 128, an odd head count at head dim 64 (a
    128-column tile would straddle two of q, k, v; 3C is then no multiple of
    128, the tiles)."""
    d = C // heads
    x, w = _meta(2, 8, C, dtype=bf16), _meta(C, 3 * C, dtype=bf16)
    common = (x, _meta(C), _meta(C), w, _meta(3 * C))
    with pytest.raises(ValueError, match=match):
        if kernel == "rope":
            TFQ.fused_ln_qkv_rope_fwd(*common, _meta(d), _meta(d), _meta(d), _meta(d),
                                      _meta(8, d), _meta(8, d), heads)
        else:
            TFQ.fused_ln_qkv_fwd(*common, heads)
    # what the body takes: the main path's widths, C = 768 (3C = 2304), C =
    # 384 (vit_small, 6 heads of 64) and 8 heads of 128
    for c_ok, h_ok in ((1024, 16), (768, 12), (384, 6), (1024, 8)):
        TFQ._check_widths("fused_ln_qkv", head_dim=c_ok // h_ok, C=c_ok)
        TFQ._check_tile_widths("fused_ln_qkv", c_ok, 3 * c_ok)


@pytest.mark.parametrize("C,hidden,ok", [(1024, 4096, True), (96, 4096, False),
                                         (1024, 4160, False)])
def test_wrappers_refuse_widths_the_body_does_not_take(C, hidden, ok):
    """On a CUDA tensor the MLP wrappers check the widths the GEMM body and
    its pre-pass take (checked before anything is built, so here without a
    card): 128-column tiles, K slices of 64."""
    if ok:
        TFQ._check_tile_widths("fused_mlp_up", C, hidden)
    else:
        with pytest.raises(ValueError, match="multiple of"):
            TFQ._check_tile_widths("fused_mlp_up", C, hidden)


# -- LN+QKV(+RoPE) on one rank's head shard (tensor parallelism) -----------------

# H = 16 heads of 64 at C = 1024; a model extent m leaves Hl = 16 / m heads a
# rank: nout = 3 Hl 64 = 1536 / 768 / 384 (12 / 6 / 3 column tiles, each two
# heads of one of q, k, v), K stays C
SHARD_HEADS = (8, 4, 2)
SHARD_ROWS, SHARD_EPS = 200, 1e-5


def _shard_ranks(hl):
    m = C_FULL // HD // hl
    return sorted({0, m - 1})


@pytest.fixture(scope="module")
def shard_inputs():
    rng = np.random.default_rng(19)
    C = C_FULL
    x = rng.normal(size=(1, SHARD_ROWS, C))
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    host = dict(lw=1 + 0.1 * f32(C), lb=0.1 * f32(C), b=0.1 * f32(3 * C),
                qw=1 + 0.1 * f32(HD), qb=0.1 * f32(HD), kw=1 + 0.1 * f32(HD), kb=0.1 * f32(HD))
    ang = rng.uniform(-np.pi, np.pi, size=(SHARD_ROWS, HD))
    host.update(cos=np.cos(ang).astype(np.float32), sin=np.sin(ang).astype(np.float32))
    jx, tx = _pair(x)
    jw, tw = _pair(rng.normal(scale=C**-0.5, size=(C, 3 * C)))
    return dict(x=(jx, tx), w=(jw, tw), t={k: torch.from_numpy(v) for k, v in host.items()},
                j={k: jnp.asarray(v) for k, v in host.items()})


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("hl,i", [(hl, i) for hl in SHARD_HEADS for i in _shard_ranks(hl)])
def test_qkv_head_shard_matches_jax_tp_slice(shard_inputs, hl, i, rope):
    """The emulated kernel on rank i's head shard, the (C, 3 Hl 64) weight
    of ``sharding.model_part`` (its heads' columns of q, of k and of v), at
    K = C = 1024: against JAX's plain chain on ``_tp_local_attn``'s sliced
    params (layer norm, ``qkv_heads`` with Hl heads: JAX's fused kernel
    cannot take the shard, it reads d from x's width) and against the
    port's plain version on the same shard, at phase 2's ulps."""
    from self_supervise_sfm_tpu.layers import attention as JAttn
    from self_supervise_sfm_tpu.layers import params as JP
    from self_supervise_sfm_tpu.layers.block import BlockConfig as JBlockConfig
    from self_supervise_sfm_tpu.parallel import sp_block as JSP
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    H, m = C_FULL // HD, C_FULL // HD // hl
    (jx, tx), (jw, tw), t, j = (shard_inputs[k] for k in ("x", "w", "t", "j"))
    tw_i = Sh.model_part(tw, -1, m, i, 3)
    tb_i = Sh.model_part(t["b"], -1, m, i, 3)
    assert tw_i.shape == (C_FULL, 3 * hl * HD)
    jcfg = JBlockConfig(dim=C_FULL, num_heads=H, qk_norm=rope)
    att = {"qkv": {"w": jw.astype(jnp.float32), "b": j["b"]}}
    if rope:
        att.update(q_norm={"scale": j["qw"], "bias": j["qb"]},
                   k_norm={"scale": j["kw"], "bias": j["kb"]})
    local = JSP._tp_local_attn(att, i, jcfg, m)
    h = JP.layer_norm({"scale": j["lw"], "bias": j["lb"]}, jx, SHARD_EPS)
    lcfg = JAttn.AttentionConfig(dim=hl * HD, num_heads=hl, qk_norm=rope, ln_eps=SHARD_EPS)
    ref = JAttn.qkv_heads(local, h, lcfg, (j["cos"], j["sin"]) if rope else None)
    if rope:
        norms = ((t["qw"], t["qb"]), (t["kw"], t["kb"]))
        emu = _qkv(tx, t["lw"], t["lb"], tw_i, tb_i, hl, SHARD_EPS, norms, t["cos"], t["sin"])
        plain = TFQ.fused_ln_qkv_rope_plain(tx, t["lw"], t["lb"], tw_i, tb_i, t["qw"], t["qb"],
                                            t["kw"], t["kb"], t["cos"], t["sin"], hl, SHARD_EPS)
    else:
        emu = _qkv(tx, t["lw"], t["lb"], tw_i, tb_i, hl, SHARD_EPS)
        plain = TFQ.fused_ln_qkv_plain(tx, t["lw"], t["lb"], tw_i, tb_i, hl, SHARD_EPS)
    kernel = "rope" if rope else "plain"
    for got in (emu, plain):
        for g in got:
            assert g.shape == (1, hl, SHARD_ROWS, HD)
    _assert_qkv(emu, ref, kernel, f"head shard Hl={hl} rank {i} vs JAX's slice")
    _assert_qkv(emu, plain, kernel, f"head shard Hl={hl} rank {i} vs the plain version")


def test_qkv_head_shard_at_every_head_is_the_whole_kernel(shard_inputs):
    """At m = 1 the shard is the whole weight: the same emulation, bit for
    bit, as the whole-width call (``tests`` above)."""
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    (_, tx), (_, tw), t = (shard_inputs[k] for k in ("x", "w", "t"))
    H = C_FULL // HD
    assert torch.equal(Sh.model_part(tw, -1, 1, 0, 3), tw)
    a = _qkv(tx, t["lw"], t["lb"], Sh.model_part(tw, -1, 1, 0, 3), t["b"], H, SHARD_EPS)
    b = _qkv(tx, t["lw"], t["lb"], tw, t["b"], H, SHARD_EPS)
    assert all(torch.equal(u, w) for u, w in zip(a, b))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hl", [8, 4, 2, 1, 3, 5])
def test_qkv_head_shard_widths_and_routes(hl, d):
    """The head-shard form on meta tensors (the card's checks, raising
    before any build): x (B, N, 1024) and w (1024, 3 Hl d); at head dim 64
    an odd Hl refuses (a 128-column tile would straddle q | k), at 128 a
    tile is one head and every Hl is taken; the predicate
    ``qkv_kernel_takes(C, Hl, d)`` and the "auto" gates of
    ``layers/block.py`` agree with it, given the true C and Hl (not the
    shard's C / m)."""
    from self_supervise_sfm_tpu_torch.layers import block as TB

    C, H = C_FULL, C_FULL // d
    takes = d == 128 or hl % 2 == 0
    assert TFQ.qkv_kernel_takes(C, hl, head_dim=d) == takes
    nout = 3 * hl * d
    x, w = _meta(2, 8, C, dtype=bf16), _meta(C, nout, dtype=bf16)
    if takes:
        assert TFQ._qkv_widths("fused_ln_qkv", x, w, hl) == d
    else:
        with pytest.raises(ValueError, match="even head count"):
            TFQ.fused_ln_qkv_fwd(x, _meta(C), _meta(C), w, _meta(nout), hl)
        with pytest.raises(ValueError, match="even head count"):
            TFQ.fused_ln_qkv_rope_fwd(x, _meta(C), _meta(C), w, _meta(nout), _meta(d),
                                      _meta(d), _meta(d), _meta(d), _meta(8, d),
                                      _meta(8, d), hl)
    cfg = TB.BlockConfig(dim=C, num_heads=H, qk_norm=True)
    p = {"norm1": {}, "attn": {"qkv": {"w": w, "b": _meta(nout)}, "q_norm": {}, "k_norm": {}}}
    assert TB.local_heads(p, cfg) == hl
    rope = (_meta(8, d), _meta(8, d))
    assert TB._fused_qkv_applicable(p, cfg, x, rope) == takes
    vit = TB.BlockConfig(dim=C, num_heads=H)
    assert TB._fused_qkv_plain_applicable(p, vit, x) == takes
