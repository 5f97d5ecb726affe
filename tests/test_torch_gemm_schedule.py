"""The arithmetic and tile schedule of the Hopper GEMM body (MLP-up, MLP-down),
emulated on the CPU and held against the JAX Pallas kernels, the JAX
reference chain and the port's plain versions.

``csrc/gemm_sm90.cu`` runs only on the card. :func:`_up` and :func:`_down`
repeat its arithmetic in PyTorch: the layer-norm pre-pass (fp32 statistics,
centred variance, the rows rounded to bf16 before the product), fp32
accumulation over K slices of BK = 64 in order, and the epilogues' rounding
points (``rb(rb(acc) + rb(b))``, then the erf GELU in fp32; ``rb(x +
rb(v * rb(gamma)))``). They are held against ``fused_mlp_kernel(...,
interpret=True)`` and ``reference_mlp`` of the JAX package and against the
port's plain versions, with the tolerance phase 2 of ``chip_smoke.py``
applies on the card: 2 bf16 ulps at the largest output. Rows are ragged
(200 and 1374, no multiple of 128), the eps is the ViT's and the
aggregator's, and one row is all zeros. The persistent tile walk (tile ->
row tile, column tile in raster groups; a block's tiles shared out between
its two consumer warpgroups; the ring positions and the ping-pong turns)
is mirrored in Python, with its constants read from the source, and must
cover every output tile exactly once at the main path's four site shapes.
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

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parents[1] / "self_supervise_sfm_tpu_torch" / "csrc"
          / "gemm_sm90.cu").read_text()


def _const(name: str) -> str:
    found = re.findall(rf"constexpr \w+ {name} = ([^;]+);", SOURCE)
    assert len(found) == 1, name
    return found[0]


BK, BN, WG_M = int(_const("BK")), int(_const("BN")), int(_const("WG_M"))
GROUP_M, STAGES = int(_const("GROUP_M")), int(_const("STAGES"))
PINGPONG = _const("PINGPONG") == "true"
SMS = 132  # multiprocessors of an H100 SXM: the persistent grid's size
# rows of the main path's sites (B * N) and the MLP widths
SITE_ROWS = {"vit": 5 * 1374, "frame": 10 * 1374, "reloc": 5 * 1374, "global": 6870}
C_FULL, CH_FULL = 1024, 4096
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


# -- the persistent tile walk ---------------------------------------------------


def _tile_coords(t: int, m_tiles: int, n_tiles: int, group: int = GROUP_M):
    """tile_coords: raster groups of `group` row tiles, column by column."""
    per_group = group * n_tiles
    first = (t // per_group) * group
    rows = min(m_tiles - first, group)
    r = t % per_group
    return first + r % rows, r // rows


def _walk(M: int, nout: int, pingpong: bool = PINGPONG, group: int = GROUP_M):
    """(block, warpgroup, block-local index i, row tile, column tile) of every
    tile a launch computes, as the consumers walk them."""
    bm = WG_M if pingpong else 2 * WG_M
    m_tiles, n_tiles = -(-M // bm), nout // BN
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


@pytest.mark.parametrize("kernel", ["up", "down"])
@pytest.mark.parametrize("site", list(SITE_ROWS))
def test_tile_walk_covers_every_tile_once(site, kernel):
    M = SITE_ROWS[site]
    nout = CH_FULL if kernel == "up" else C_FULL
    for pingpong in (True, False):
        for group in sorted({GROUP_M, 1, 8}):
            walk, m_tiles, n_tiles, _ = _walk(M, nout, pingpong, group)
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


@pytest.mark.parametrize("kernel", ["up", "down"])
def test_ring_positions_and_turns(kernel):
    """The producer fills the ring tile after tile, K slice after K slice;
    a consumer starts the block's tile i at ring position i * k_tiles, i.e.
    stage (i k) % STAGES of phase (i k / STAGES) & 1. The ping-pong turns:
    the block's tile i is issued in warpgroup i % 2's turn, passed on only
    when tile i + 1 exists, so every arrival on a named barrier meets one
    wait."""
    M = SITE_ROWS["vit"]
    nout, K = (CH_FULL, C_FULL) if kernel == "up" else (C_FULL, CH_FULL)
    k_tiles = K // BK
    walk, _, _, grid = _walk(M, nout, True)
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


@pytest.mark.parametrize("C,hidden,ok", [(1024, 4096, True), (128, 4096, False),
                                         (1024, 4160, False)])
def test_wrappers_refuse_widths_the_body_does_not_take(C, hidden, ok):
    """On a CUDA tensor the MLP wrappers check the widths the GEMM body and
    its pre-pass take (checked before anything is built, so here without a
    card): 128-column tiles, 256-channel steps of the layer norm."""
    if ok:
        TFQ._check_tile_widths("fused_mlp_up", C, hidden)
    else:
        with pytest.raises(ValueError, match="multiple of"):
            TFQ._check_tile_widths("fused_mlp_up", C, hidden)
