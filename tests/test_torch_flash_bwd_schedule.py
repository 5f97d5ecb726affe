"""The Hopper backward body (B9's dq and dk/dv kernels, unmasked and under a
RelocMask), emulated on the CPU and held against the JAX Pallas backward and
the port's plain version; the masked forms' segment-aligned work tiles
walked in Python; the "auto" attention gates on the card, shown through
meta tensors; the source's constants and the ablation tool's patches.

``csrc/flash_bwd_sm90.cu`` runs only on the card. :func:`_emulate_dkv` and
:func:`_emulate_dq` repeat its arithmetic tile by tile in PyTorch: the dk/dv
kernel streams the slice's q rows in tiles of ``KV_BQ`` (zero-filled past
nq, lse and delta 0 there) in order against each 128-key work tile, the dq
kernel streams keys in tiles of ``DQ_BK`` (zero-filled past nk); p =
exp2(s * c - lse * log2(e)) with lse * log2(e) rounded once in fp32 and one
rounding of the FFMA's argument, flushed to zero below 2^-126
(ex2.approx.ftz), selected to 0 past nk (and past nq for dk/dv); ds = p *
(dp - delta) * scale; p and ds rounded to bf16 before their products, fp32
sums a tile at a time, the results rounded to bf16. It is held against the
Pallas ``_flash_bwd`` in interpret mode (as ``test_torch_train_ops.py``
runs it, on the Pallas forward's own out and lse) and against
``flash_bwd_plain``, with the tolerance phase 2 of ``chip_smoke.py`` applies
on the card: 4 bf16 ulps at the largest |gradient| of each output.

Under a RelocMask (keys [n_ctx context | F frames of P], a q row of frame f
seeing the context and frame f's keys) the kernels' work tiles start and end
at the segments: :func:`_dkv_work` and :func:`_dq_work` transcribe the
source's decoders, and :func:`_emulate_dkv_masked` / :func:`_emulate_dq_masked`
repeat the arithmetic over them: a dk/dv work tile of up to 128 keys of one
segment streams all q rows (context) or its frame's (64 at a time, from the
frame's first row), a dq work tile of up to 128 q rows of one frame streams
the context's 128-key tiles, then its frame's; whatever lies past a tile's
ends gets p = 0 and adds exact zeros. They are held against the Pallas
``_flash_bwd`` with the mask in interpret mode and ``flash_bwd_plain`` with
the mask, at 4 ulps.

The gates: on a CUDA tensor (here a meta tensor, which takes the card's
checks; the launch is recorded in place of a build) the "auto" route of
``sdpa`` (unmasked, and under a RelocMask to K1m), the frame-context gate,
the reloc-split gate and ``packed_ctx_attention`` sends head dims other
than 64 to the dense path, bf16 sites to the Hopper kernels and fp32 sites
to the FFMA kernels, with or without grad (the backward through B9's fp32
entries; K2p, which has no backward, dense under grad); ``impl="flash"``
with fp32 launches the fp32 entries; ``flash_bwd`` reaches the Hopper
body's unmasked entries, or its RelocMask entries with a mask, and the FFMA
body's in fp32.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.ops import flash_attention as JFA
from self_supervise_sfm_tpu.ops.mask_spec import RelocMask as JRelocMask
from self_supervise_sfm_tpu_torch import _kernels as TK
from self_supervise_sfm_tpu_torch.layers import attention as TAT
from self_supervise_sfm_tpu_torch.ops import attention_core as TAC
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA
from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask
from self_supervise_sfm_tpu_torch.tools import ablate_attention as ABL

torch.set_num_threads(1)

CSRC = Path(TFA.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "flash_bwd_sm90.cu").read_text()


def _const(name: str) -> str:
    m = re.search(rf"constexpr (?:int|bool) {name} = ([^;]+);", SOURCE)
    assert m, name
    return m.group(1)


KV_BM, KV_BQ, DQ_BM, DQ_BK = (int(_const(n)) for n in ("KV_BM", "KV_BQ", "DQ_BM", "DQ_BK"))
KV_STAGES, DQ_STAGES = int(_const("KV_STAGES")), int(_const("DQ_STAGES"))
SNAKE, CTX_FIRST = (_const(n) == "true" for n in ("SNAKE", "CTX_FIRST"))
D = 64
# head dim -> (q rows a streamed dk/dv tile, its ring stages, keys a streamed
# dq tile, its ring stages, K / V of dk/dv in registers), as the source sets
# them
TILES = {64: (KV_BQ, KV_STAGES, DQ_BK, DQ_STAGES, _const("KV_IN_REGS") == "true"),
         128: (int(_const("KV_BQ_D128")), int(_const("KV_STAGES_D128")),
               int(_const("DQ_BK_D128")), int(_const("DQ_STAGES_D128")),
               _const("KV_IN_REGS_D128") == "true")}
LOG2E = 1.4426950408889634
SMS = 132


def _ulps(ref, n: int) -> float:
    """n bf16 ulps at the largest |ref|."""
    return n * 2.0 ** (math.floor(math.log2(float(np.abs(_np(ref)).max()))) - 7)


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.array(x.astype(jnp.float32))


def _exp2_ftz(x: torch.Tensor) -> torch.Tensor:
    p = torch.exp2(x)
    return torch.where(p < 2.0**-126, torch.zeros_like(p), p)


def _ffma(s, c, b):
    """s * c - b with one rounding, as the FFMA (the product exact in fp64)."""
    return (s.double() * float(c) - b.double()).float()


def _scales(d: int = D):
    """The wrapper's fp32 scale * log2(e) and scale, as ctypes passes them."""
    return (np.float32(d**-0.5 * LOG2E), np.float32(d**-0.5))


def _lse2(lse):
    return lse.float() * torch.tensor(np.float32(LOG2E))


def _pad(x, n0, n):
    """Rows [n0, n0 + n) of (S, N, ...) x, zero-filled past N (a TMA box)."""
    out = torch.zeros((x.shape[0], n, *x.shape[2:]), dtype=x.dtype)
    valid = max(0, min(n, x.shape[1] - n0))
    out[:, :valid] = x[:, n0:n0 + valid]
    return out, valid


def _emulate_dkv(q, k, v, do, lse, delta):
    """dk, dv as the dk/dv kernel computes them: q tiles of its head dim's
    KV_BQ in order."""
    S, nq, d = q.shape
    c, scale = _scales(d)
    bq = TILES[d][0]
    nk = k.shape[1]
    lse2 = _lse2(lse)
    dk = torch.zeros((S, nk, d))
    dv = torch.zeros((S, nk, d))
    for q0 in range(0, nq, bq):
        qt, valid = _pad(q, q0, bq)
        dot, _ = _pad(do, q0, bq)
        l2, _ = _pad(lse2, q0, bq)
        dl, _ = _pad(delta.float(), q0, bq)
        st = torch.matmul(k.float(), qt.float().transpose(-1, -2))  # S^T (S, nk, BQ)
        dpt = torch.matmul(v.float(), dot.float().transpose(-1, -2))
        p = _exp2_ftz(_ffma(st, c, l2[:, None, :]))
        p[..., valid:] = 0.0
        ds = p * (dpt - dl[:, None, :]) * torch.tensor(scale)
        dv = dv + torch.matmul(p.to(torch.bfloat16).float(), dot.float())
        dk = dk + torch.matmul(ds.to(torch.bfloat16).float(), qt.float())
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _emulate_dq(q, k, v, do, lse, delta):
    """dq as the dq kernel computes it: key tiles of its head dim's DQ_BK in
    order."""
    S, nq, d = q.shape
    c, scale = _scales(d)
    bk = TILES[d][2]
    nk = k.shape[1]
    lse2 = _lse2(lse)
    dq = torch.zeros((S, nq, d))
    for k0 in range(0, nk, bk):
        kt, valid = _pad(k, k0, bk)
        vt, _ = _pad(v, k0, bk)
        s = torch.matmul(q.float(), kt.float().transpose(-1, -2))
        dp = torch.matmul(do.float(), vt.float().transpose(-1, -2))
        p = _exp2_ftz(_ffma(s, c, lse2[..., None]))
        p[..., valid:] = 0.0
        ds = p * (dp - delta.float()[..., None]) * torch.tensor(scale)
        dq = dq + torch.matmul(ds.to(torch.bfloat16).float(), kt.float())
    return dq.to(torch.bfloat16)


def _bf16_pair(rng, shape):
    """The same bf16 values for JAX and for PyTorch."""
    a = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jnp.bfloat16)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


# (nq, nk, with an lse cotangent, head dim): ragged q and key tiles on both
# sides, and the split context's shape, fewer keys than q rows; at head dim
# 128 ragged q tiles of 32 rows and key tiles of 64 with dlse
CASES = {"130x77": (130, 77, False, 64), "130x77_dlse": (130, 77, True, 64),
         "257x130": (257, 130, False, 64), "257x130_dlse": (257, 130, True, 64),
         "context_300x140_dlse": (300, 140, True, 64),
         "d128_150x77_dlse": (150, 77, True, 128)}


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(13)
    out = {}
    for name, (nq, nk, with_dlse, d) in CASES.items():
        (jq, tq), (jdo, tdo) = (_bf16_pair(rng, (2, nq, d)) for _ in range(2))
        (jk, tk), (jv, tv) = (_bf16_pair(rng, (2, nk, d)) for _ in range(2))
        jdlse = jnp.asarray(rng.normal(size=(2, nq)), jnp.float32) if with_dlse else None
        tdlse = None if jdlse is None else torch.from_numpy(np.array(jdlse))
        j_out, j_lse = JFA._flash_fwd(jq, jk, jv, None, 128, 128, True)
        pallas = JFA._flash_bwd(jq, jk, jv, j_out, j_lse, jdo, None, 128, 128, True,
                                dlse=jdlse)
        to = torch.from_numpy(np.array(j_out.astype(jnp.float32))).to(torch.bfloat16)
        tl = torch.from_numpy(np.array(j_lse))
        delta = TFA._delta(to, tdo, tdlse)
        emu = (_emulate_dq(tq, tk, tv, tdo, tl, delta),
               *_emulate_dkv(tq, tk, tv, tdo, tl, delta))
        plain = TFA.flash_bwd_plain(tq, tk, tv, to, tl, tdo, tdlse)
        out[name] = dict(emu=emu, pallas=pallas, plain=plain)
    return out


@pytest.mark.parametrize("ref", ["pallas", "plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_schedule_matches(cases, case, ref):
    for label, got, want in zip(("dq", "dk", "dv"), cases[case]["emu"], cases[case][ref]):
        err = float(np.abs(_np(got) - _np(want)).max())
        tol = _ulps(want, 4)
        assert err <= tol, f"{case} {label} vs {ref}: max abs error {err} over {tol}"


def test_bwd_schedule_is_not_the_plain_arithmetic(cases):
    """The emulation rounds where the kernel rounds (the FFMA, the tiles'
    bf16 p / ds against tile-wise sums), not as the plain version: on the
    ragged cases it differs from it somewhere, inside the tolerance."""
    assert any(not torch.equal(a, b) for case in cases.values()
               for a, b in zip(case["emu"], case["plain"]))


def test_edge_selects_keep_nan_and_inf_out():
    """A key past nk reads as zeros: s = 0 and p = exp2(-lse2), which is inf
    where lse2 < -128; a q row past nq has lse and delta 0: p = 1. The
    kernels select both to 0 before any product, so a tile of such rows adds
    exact zeros, never inf * 0."""
    c, _ = _scales()
    lse2 = torch.tensor([-200.0, 0.0])
    s = torch.zeros(2)
    p = _exp2_ftz(_ffma(s, c, lse2))
    assert torch.isinf(p[0]) and p[1] == 1.0
    assert torch.equal(torch.where(torch.tensor([False, False]), p, torch.zeros(2)),
                       torch.zeros(2))
    for line in ("if (edge) pe = k0 + 8 * j + 2 * t + (e & 1) < k_end ? pe : 0.f;",
                 "const bool ok = ((e >> 1) ? kok1 : kok0) && q0 + c + (e & 1) < w.s_end;",
                 "pe = ok ? pe : 0.f;"):
        assert line in SOURCE, line


# -- the RelocMask forms: segment-aligned work tiles ---------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _params(slices: int, nq: int, nk: int, mask, kernel: str) -> dict:
    """The fields of the source's Params a launch sets (launch_dq /
    launch_dkv): without a mask the context is all nk keys and the q rows
    one frame."""
    n_ctx, frame = (nk, nq) if mask is None else (mask.n_ctx, mask.frame_size)
    p = dict(slices=slices, nq=nq, nk=nk, n_ctx=n_ctx, frame=frame, frames=nq // frame)
    if kernel == "dq":
        p["tiles"] = slices * p["frames"] * _cdiv(frame, DQ_BM)
    else:
        own = p["frames"] * _cdiv(frame, KV_BM) if mask is not None else 0
        p["tiles"] = slices * (_cdiv(n_ctx, KV_BM) + own)
    return p


def _dkv_work(p: dict, t: int, masked: bool):
    """dkv_work: (slice, r0, r_end, s0, s_end) of dk/dv work tile t, keys
    [r0, r_end) against q rows [s0, s_end)."""
    ctx_tiles = _cdiv(p["n_ctx"], KV_BM)
    ctx = p["slices"] * ctx_tiles
    if masked and not CTX_FIRST:
        t = (t + ctx) % p["tiles"]
    if not masked or t < ctx:
        k0 = (t % ctx_tiles) * KV_BM
        return t // ctx_tiles, k0, min(k0 + KV_BM, p["n_ctx"]), 0, p["nq"]
    t -= ctx
    per_frame = _cdiv(p["frame"], KV_BM)
    per_slice = p["frames"] * per_frame
    r = t % per_slice
    f0 = (r // per_frame) * p["frame"]
    k0 = p["n_ctx"] + f0 + (r % per_frame) * KV_BM
    return t // per_slice, k0, min(k0 + KV_BM, p["n_ctx"] + f0 + p["frame"]), f0, f0 + p["frame"]


def _dq_work(p: dict, t: int, masked: bool):
    """dq_work: (slice, r0, r_end, s0, s_end) of dq work tile t, q rows
    [r0, r_end) and own-frame keys [s0, s_end)."""
    per_frame = _cdiv(p["frame"], DQ_BM)
    per_slice = p["frames"] * per_frame
    r = t % per_slice
    f0 = (r // per_frame) * p["frame"]
    q0 = f0 + (r % per_frame) * DQ_BM
    own = p["n_ctx"] + f0 if masked else 0
    return t // per_slice, q0, min(q0 + DQ_BM, f0 + p["frame"]), own, own + p["frame"] if masked else 0


def _dq_key_tiles(p: dict, w, bk: int = DQ_BK):
    """dq_key_tile<BK> over a work tile's steps: (k0, end) of each key tile."""
    ctx = _cdiv(p["n_ctx"], bk)
    for i in range(ctx + _cdiv(w[4] - w[3], bk)):
        k0 = i * bk if i < ctx else w[3] + (i - ctx) * bk
        yield k0, min(k0 + bk, p["n_ctx"] if i < ctx else w[4])


def _kv_q_tiles(w, bq: int = KV_BQ):
    """The q tiles a dk/dv work tile streams: (q0, end of its rows)."""
    return [(q0, min(q0 + bq, w[4])) for q0 in range(w[3], w[4], bq)]


def _emulate_dkv_masked(q, k, v, do, lse, delta, mask):
    """dk, dv as the RelocMask dk/dv kernel computes them: each work tile's
    keys against its q rows in tiles of KV_BQ, in order (one slice's walk;
    every slice alike)."""
    S, nq, d = q.shape
    c, scale = _scales(d)
    nk = k.shape[1]
    lse2 = _lse2(lse)
    dk, dv = torch.zeros((S, nk, d)), torch.zeros((S, nk, d))
    p = _params(1, nq, nk, mask, "dkv")
    for t in range(p["tiles"]):
        w = _dkv_work(p, t, True)
        k0, k_end = w[1], w[2]
        kt, vt = k[:, k0:k_end].float(), v[:, k0:k_end].float()
        for q0, q1 in _kv_q_tiles(w, TILES[d][0]):
            qt, dot = q[:, q0:q1].float(), do[:, q0:q1].float()
            pp = _exp2_ftz(_ffma(torch.matmul(kt, qt.transpose(-1, -2)), c,
                                 lse2[:, None, q0:q1]))
            dpt = torch.matmul(vt, dot.transpose(-1, -2))
            ds = pp * (dpt - delta.float()[:, None, q0:q1]) * torch.tensor(scale)
            dv[:, k0:k_end] += torch.matmul(pp.to(torch.bfloat16).float(), dot)
            dk[:, k0:k_end] += torch.matmul(ds.to(torch.bfloat16).float(), qt)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _emulate_dq_masked(q, k, v, do, lse, delta, mask):
    """dq as the RelocMask dq kernel computes it: each work tile's q rows
    against the context's key tiles, then its frame's, in order."""
    S, nq, d = q.shape
    c, scale = _scales(d)
    nk = k.shape[1]
    lse2 = _lse2(lse)
    dq = torch.zeros((S, nq, d))
    p = _params(1, nq, nk, mask, "dq")
    for t in range(p["tiles"]):
        w = _dq_work(p, t, True)
        q0, q1 = w[1], w[2]
        qt, dot = q[:, q0:q1].float(), do[:, q0:q1].float()
        for k0, k1 in _dq_key_tiles(p, w, TILES[d][2]):
            kt, vt = k[:, k0:k1].float(), v[:, k0:k1].float()
            pp = _exp2_ftz(_ffma(torch.matmul(qt, kt.transpose(-1, -2)), c,
                                 lse2[:, q0:q1, None]))
            dp = torch.matmul(dot, vt.transpose(-1, -2))
            ds = pp * (dp - delta.float()[:, q0:q1, None]) * torch.tensor(scale)
            dq[:, q0:q1] += torch.matmul(ds.to(torch.bfloat16).float(), kt)
    return dq.to(torch.bfloat16)


# (n_ctx, P, F): context and frame tails at both kinds of boundary, no
# context, one-row frames, whole 128-row segments, and the train site's
# 98-key context tail (610 = 4 x 128 + 98) against a frame of 257 rows
MASKS = {"77x130x2": (77, 130, 2), "0x130x3": (0, 130, 3), "5x1x7": (5, 1, 7),
         "128x128x2": (128, 128, 2), "98x257x2": (98, 257, 2)}
MASKED_CASES = [f"{m}{'_dlse' if dl else ''}" for m in MASKS for dl in (False, True)]
# at head dim 128: a context and frames whose ends fall inside 32-row q
# tiles and 64-key tiles, with dlse
MASKED_CASES.append("d128_77x130x2_dlse")


@pytest.fixture(scope="module")
def masked_cases():
    rng = np.random.default_rng(17)
    out = {}
    for name in MASKED_CASES:
        d = 128 if name.startswith("d128_") else D
        n_ctx, fs, nf = MASKS[name.removeprefix("d128_").removesuffix("_dlse")]
        mask, jmask = RelocMask(n_ctx, fs, nf), JRelocMask(n_ctx, fs, nf)
        (jq, tq), (jdo, tdo) = (_bf16_pair(rng, (2, mask.nq, d)) for _ in range(2))
        (jk, tk), (jv, tv) = (_bf16_pair(rng, (2, mask.nk, d)) for _ in range(2))
        with_dlse = name.endswith("_dlse")
        jdlse = jnp.asarray(rng.normal(size=(2, mask.nq)), jnp.float32) if with_dlse else None
        tdlse = None if jdlse is None else torch.from_numpy(np.array(jdlse))
        j_out, j_lse = JFA._flash_fwd(jq, jk, jv, jmask, 128, 128, True)
        pallas = JFA._flash_bwd(jq, jk, jv, j_out, j_lse, jdo, jmask, 128, 128, True,
                                dlse=jdlse)
        to = torch.from_numpy(np.array(j_out.astype(jnp.float32))).to(torch.bfloat16)
        tl = torch.from_numpy(np.array(j_lse))
        delta = TFA._delta(to, tdo, tdlse)
        emu = (_emulate_dq_masked(tq, tk, tv, tdo, tl, delta, mask),
               *_emulate_dkv_masked(tq, tk, tv, tdo, tl, delta, mask))
        plain = TFA.flash_bwd_plain(tq, tk, tv, to, tl, tdo, tdlse, mask)
        out[name] = dict(emu=emu, pallas=pallas, plain=plain)
    return out


@pytest.mark.parametrize("ref", ["pallas", "plain"])
@pytest.mark.parametrize("case", MASKED_CASES)
def test_masked_bwd_schedule_matches(masked_cases, case, ref):
    for label, got, want in zip(("dq", "dk", "dv"), masked_cases[case]["emu"],
                                masked_cases[case][ref]):
        err = float(np.abs(_np(got) - _np(want)).max())
        tol = _ulps(want, 4)
        assert err <= tol, f"{case} {label} vs {ref}: max abs error {err} over {tol}"


def test_masked_schedule_is_not_the_plain_arithmetic(masked_cases):
    """The masked emulation rounds where the kernels round (the FFMA, bf16 p
    / ds a tile at a time, the context's sums before the frame's), not as
    the plain version: it differs from it somewhere, inside the tolerance."""
    assert any(not torch.equal(a, b) for case in masked_cases.values()
               for a, b in zip(case["emu"], case["plain"]))


def _walk(tiles: int, masked: bool = False):
    """The persistent grid (tile_at): block b takes work tile k * grid + b in
    round k, or k * grid + grid - 1 - b on an odd round of a masked walk."""
    grid = min(tiles, SMS)
    walk = {}
    for b in range(grid):
        mine, k = [], 0
        while (t := k * grid + (grid - 1 - b if masked and SNAKE and k % 2 else b)) < tiles:
            mine.append(t)
            k += 1
        walk[b] = mine
    return walk


# the train step's reloc layer 0 and phase 4's 5-query mask-form check
# (BH, RelocMask), cut to 2 slices: every slice walks alike
MASK_SITES = {"reloc layer 0": (16, (610, 1374, 2)), "reloc 5 queries": (16, (1525, 1374, 5))}
WALKS = {**{m: (2, MASKS[m]) for m in MASKS}, **{s: (2, m) for s, (_, m) in MASK_SITES.items()}}


@pytest.mark.parametrize("case", list(WALKS))
def test_masked_walk_visits_each_allowed_pair_once(case):
    """Across the work tiles of both kernels: every allowed (q, k) pair of
    every slice is visited once a kernel, and no dead pair inside a tile's
    ends (dead pairs only in its tails, where p = 0); every key row (dk/dv)
    and q row (dq) is stored by one work tile; every work tile is taken by
    one block of the walk."""
    _check_walk(case, TILES[64][0], TILES[64][2])


@pytest.mark.parametrize("case", list(MASKS))
def test_masked_walk_at_d128_visits_each_allowed_pair_once(case):
    """The same with the head dim 128 kernels' streamed tiles (32-row q
    tiles, 64-key tiles): the work tiles are the head dim 64 ones."""
    _check_walk(case, TILES[128][0], TILES[128][2])


def _check_walk(case: str, bq: int, bk: int) -> None:
    slices, (n_ctx, fs, nf) = WALKS[case]
    mask = RelocMask(n_ctx, fs, nf)
    nq, nk = mask.nq, mask.nk
    allowed = mask.materialize()[0, 0].numpy()
    for kernel in ("dkv", "dq"):
        p = _params(slices, nq, nk, mask, kernel)
        seen = sorted(t for ts in _walk(p["tiles"], True).values() for t in ts)
        assert seen == list(range(p["tiles"]))
        visits = np.zeros((slices, nq, nk), np.int32)
        stored = np.zeros((slices, nk if kernel == "dkv" else nq), np.int32)
        for t in range(p["tiles"]):
            if kernel == "dkv":
                w = _dkv_work(p, t, True)
                sl, k0, k_end = w[0], w[1], w[2]
                assert k_end - k0 <= KV_BM
                for q0, q1 in _kv_q_tiles(w, bq):
                    visits[sl, q0:q1, k0:k_end] += 1
            else:
                w = _dq_work(p, t, True)
                sl, k0, k_end = w[0], w[1], w[2]
                assert k_end - k0 <= DQ_BM
                for kt0, kt1 in _dq_key_tiles(p, w, bk):
                    assert kt1 - kt0 <= bk
                    visits[sl, k0:k_end, kt0:kt1] += 1
            stored[sl, k0:k_end] += 1
        assert (stored == 1).all(), f"{kernel}: a row stored {stored.min()}-{stored.max()} times"
        assert (visits == allowed[None].astype(np.int32)).all(), \
            f"{kernel}: pairs visited {visits.max()} times at most, or a dead pair visited"


def test_masked_work_tiles_at_the_train_site():
    """The counts the source's header quotes at the train step's reloc layer
    0: 27 dk/dv work tiles a slice (5 context of 43 q tiles, 2 x 11 frame
    of 22) and 22 dq work tiles (of 5 + 11 key tiles); the busiest block's
    q tiles against the mean, and against a round-robin walk and the frame
    tiles first; the context's last tile 98 keys, a frame's last 94."""
    bh, (n_ctx, fs, nf) = MASK_SITES["reloc layer 0"]
    mask = RelocMask(n_ctx, fs, nf)
    kv = _params(1, mask.nq, mask.nk, mask, "dkv")
    dq = _params(1, mask.nq, mask.nk, mask, "dq")
    works = [_dkv_work(kv, t, True) for t in range(kv["tiles"])]
    assert kv["tiles"] == 27 and dq["tiles"] == 22
    steps = [len(_kv_q_tiles(w)) for w in works]
    assert steps == [43] * 5 + [22] * 22
    assert {w[2] - w[1] for w in works} == {128, 98, 94}
    assert {len(list(_dq_key_tiles(dq, _dq_work(dq, t, True)))) for t in range(22)} == {16}
    assert ("27 dk/dv work tiles a slice (5 context of 43\n//   q tiles, 2 x 11 frame of 22) "
            "and 22 dq work tiles (of 5 + 11 key\n//   tiles)") in SOURCE

    def busiest(snake: bool, ctx_first: bool) -> int:
        kvs = _params(bh, mask.nq, mask.nk, mask, "dkv")
        per = [len(_kv_q_tiles(_dkv_work(kvs, t, True))) for t in range(kvs["tiles"])]
        if not ctx_first:
            ctx = bh * 5
            per = per[ctx:] + per[:ctx]
        grid = min(len(per), SMS)
        load = [0] * grid
        for b in range(grid):
            k = 0
            while (t := k * grid + (grid - 1 - b if snake and k % 2 else b)) < len(per):
                load[b] += per[t]
                k += 1
        return max(load), sum(per) / grid

    assert (SNAKE, CTX_FIRST) == (True, True)
    shipped, mean = busiest(True, True)
    assert (shipped, round(mean, 1)) == (88, 84.7)
    assert (busiest(False, True)[0], busiest(True, False)[0]) == (109, 130)
    assert ("The busiest block streams 88 q tiles of dk/dv against 84.7 on\n//   average "
            "(109 in a plain round-robin walk, 130 with the frame tiles\n//   first and odd "
            "rounds backwards).") in SOURCE


def test_masked_stores_compare_against_the_work_tiles_end():
    """A tile's tail rows belong to a neighbour's work tile: the stores and
    the selects compare against the work tile's ends, never against N."""
    for line in ("const bool kok0 = key0 < w.r_end, kok1 = key0 + 8 < w.r_end;",
                 "if (r0 < w.r_end)", "if (r1 < w.r_end)",
                 "const bool ok = q0 + r < w.s_end;",
                 "const bool edge = edge_k || q0 + BQ > w.s_end;"):
        assert line in SOURCE, line
    assert "< p.nk" not in SOURCE.split("// -- host side")[0]


# -- the source: constants, tiles, rounds, the ring and the turns --------------

# the train step's sites (BH, Nq, Nk)
SITES = {"vit": (32, 1374, 1374), "frame": (64, 1374, 1374), "global": (16, 2748, 2748),
         "split own": (32, 1374, 1374), "split context": (32, 1374, 610)}


def _smem(d: int, tiles=None):
    """The dk/dv and dq kernels' shared memory at head dim d (with ``tiles``
    in TILES' order, or the source's), summed from the tiles: K / V slots,
    Q / dO stages with their lse / delta, barriers, and 1 KB of alignment
    slack (dk/dv); Q / dO of a work tile, K / V stages, barriers and the
    slack (dq)."""
    bq, kv_stages, bk, dq_stages, _ = tiles or TILES[d]
    row = d * 2
    kv = 1024 + 4 * KV_BM * row + kv_stages * (2 * bq * row + 2 * bq * 4) + (
        2 * kv_stages + 4) * 8
    dq = 1024 + 2 * DQ_BM * row + dq_stages * 2 * bk * row + (2 * dq_stages + 2) * 8
    return kv, dq


def test_constants_tiles_and_shared_memory():
    """The source's tiles, its shared memory inside the 227 KB a block may
    take at both head dims, and the work tiles and rounds of 132
    multiprocessors its header quotes."""
    assert (KV_BM, KV_BQ, DQ_BM, DQ_BK, KV_STAGES, DQ_STAGES) == (128, 64, 128, 128, 3, 3)
    assert _smem(64) == (117328, 132160)
    for d in (64, 128):
        assert all(b <= 232448 for b in _smem(d)), d
    # head dim 128: K / V through descriptors (they do not fit in registers
    # beside dK and dV), q tiles of 32 rows (m64n32 S^T / dP^T), dq key
    # tiles of 64 (m64n64 S / dP)
    assert TILES[128][0] == 32 and TILES[128][2] == 64 and TILES[128][4] is False
    assert TILES[64][4] is True
    # and its dk/dv warpgroups issue whenever ready (no ping-pong turns)
    assert _const("KV_PINGPONG_D128") == "false"
    assert "static constexpr bool TURNS = D == 64 ? PINGPONG : KV_PINGPONG_D128;" in SOURCE
    assert SOURCE.count("turn_end<L::TURNS>(cw, last_tile && cw == 1);") == 1
    kv_tiles = {s: bh * -(-nk // KV_BM) for s, (bh, nq, nk) in SITES.items()}
    dq_tiles = {s: bh * -(-nq // DQ_BM) for s, (bh, nq, nk) in SITES.items()}
    assert kv_tiles == {"vit": 352, "frame": 704, "global": 352, "split own": 352,
                        "split context": 160}
    assert set(dq_tiles.values()) == {352, 704}
    assert [round(kv_tiles[s] / SMS, 2) for s in ("vit", "frame", "global", "split context")] == [
        2.67, 5.33, 2.67, 1.21]
    assert "ViT / split own 352\n//   (2.67 rounds), frame 704 (5.33), global 352 (2.67), " \
           "split context 160\n//   (1.21, the last key tile 98 of 128 keys)" in SOURCE
    assert 610 - (610 // KV_BM) * KV_BM == 98
    # the shared memory the launch asks for is the layout's
    assert SOURCE.count("1024 + BAR_OFF + static_cast<int>(sizeof(DkvBarriers<STAGES>));") == 1
    assert SOURCE.count("1024 + BAR_OFF + static_cast<int>(sizeof(DqBarriers<STAGES>));") == 1
    assert "static_assert(DkvSmem<64>::SMEM_BYTES == 117328" in SOURCE
    assert "static_assert(DqSmem<64>::SMEM_BYTES == 132160" in SOURCE
    # at head dim 128 the work tiles halve with the heads (8 heads of 128)
    d128 = {s: bh // 2 * -(-nk // KV_BM) for s, (bh, nq, nk) in SITES.items()}
    assert d128 == {"vit": 176, "frame": 352, "global": 176, "split own": 176,
                    "split context": 80}
    assert "ViT / split own / global 176 (1.33 rounds), frame 352 (2.67), split\n//   " \
           "context 80 dk/dv work tiles (0.61: 52 SMs idle); dq the same, but 176 at\n//   " \
           "the split context." in SOURCE
    # the setmaxnreg split fits the 168 registers a thread at launch
    for prod, cons in (("KV_PRODUCER_REGS", "KV_CONSUMER_REGS"),
                       ("DQ_PRODUCER_REGS", "DQ_CONSUMER_REGS")):
        assert int(_const(prod)) * 128 + 2 * int(_const(cons)) * 128 <= 168 * 384


@pytest.mark.parametrize("site", list(SITES))
def test_tile_walk_and_turns(site):
    """Every work tile by one block, every key row (dk/dv) and q row (dq) of
    every slice in one work tile; the ping-pong turns: each consumer
    warpgroup issues steps + 1 times a work tile (the streamed tiles' S / dP,
    then the last accumulating products), warpgroup 0 arrives once before its
    first turn and the block's very last turn passes nothing on, so every
    arrival on a named barrier meets one wait."""
    bh, nq, nk = SITES[site]
    assert "turn_end<PINGPONG>(cw, last_tile && cw == 1);" in SOURCE
    for rows, tile_rows, steps in ((nk, KV_BM, -(-nq // KV_BQ)), (nq, DQ_BM, -(-nk // DQ_BK))):
        per_slice = -(-rows // tile_rows)
        tiles = bh * per_slice
        walk = _walk(tiles)
        seen = sorted(t for ts in walk.values() for t in ts)
        assert seen == list(range(tiles))
        covered = {(t // per_slice, r) for t in seen
                   for r in range((t % per_slice) * tile_rows,
                                  min((t % per_slice + 1) * tile_rows, rows))}
        assert len(covered) == bh * rows
        for mine in walk.values():
            arrivals, waits = {1: 1, 2: 0}, {1: 0, 2: 0}
            turns = len(mine) * (steps + 1)
            for n in range(turns):
                for cw in (0, 1):
                    waits[1 + cw] += 1
                    if not (n == turns - 1 and cw == 1):
                        arrivals[2 - cw] += 1
            assert arrivals == waits


def test_both_kernels_read_no_transposed_tile():
    """No tile is transposed in shared memory: the products that need Q, dO
    or K transposed read them MN-major through the transposed-B bit (the
    register-A products' default; at head dim 128 one m64n128 product over
    both atoms, the leading byte offset the step between them), and the
    dk/dv kernel's K / V fragments come from ldmatrix on the 128-byte
    swizzle, atom by atom."""
    assert SOURCE.count("wgmma_rs_mn<D>(dv, pa[kk], desc_add(ddo, 128 * kk));") == 1
    assert SOURCE.count("wgmma_rs_mn<D>(dk, da[kk], desc_add(dq_, 128 * kk));") == 1
    assert SOURCE.count("wgmma_rs_mn<D>(dq, da[kk], desc_add(dk_, 128 * kk));") == 1
    assert "return sw128_desc(addr, D == 64 ? 1024 >> 4 : atom >> 4);" in SOURCE
    assert "(((2 * (kk % 4) + (lane >> 4)) ^ (row & 7)) << 4)" in SOURCE
    assert "atomicAdd" not in SOURCE and "red.global" not in SOURCE and "atom." not in SOURCE


@pytest.mark.parametrize("variant", list(ABL.BWD_VARIANTS))
def test_bwd_ablation_variants_patch_the_shipped_source(variant):
    """Every backward variant of tools/ablate_attention.py finds each text it
    patches exactly once in the shipped source (the tool checks this on the
    card too, before any build), and changes the source unless it is the
    source."""
    src = ABL.patched_sources(ABL.BWD_SOURCE, {variant: ABL.BWD_VARIANTS[variant]})[variant]
    assert (src == SOURCE) == (variant == "as shipped")


@pytest.mark.parametrize("variant", list(ABL.D128_BWD_VARIANTS))
def test_d128_bwd_ablation_variants_patch_the_shipped_source(variant):
    """The same for the head dim 128 backward variants (tiles, K / V in
    registers, rings, ping-pong); each variant's shared memory still fits a
    block."""
    src = ABL.patched_sources(ABL.BWD_SOURCE, {variant: ABL.D128_BWD_VARIANTS[variant]})[variant]
    assert (src == SOURCE) == (variant == "as shipped")

    def const(name):
        return re.search(rf"constexpr (?:int|bool) {name} = ([^;]+);", src).group(1)

    tiles = [int(const(f"{n}_D128")) for n in ("KV_BQ", "KV_STAGES", "DQ_BK", "DQ_STAGES")]
    assert all(b <= 232448 for b in _smem(128, (*tiles, None)))


@pytest.mark.parametrize("variant", list(ABL.VARIANTS))
def test_fwd_ablation_variants_patch_the_shipped_source(variant):
    """The same for the forward variants (K1 / K2, flash_fwd_sm90.cu)."""
    shipped = (CSRC / ABL.SOURCE).read_text()
    src = ABL.patched_sources(ABL.SOURCE, {variant: ABL.VARIANTS[variant]})[variant]
    assert (src == shipped) == (variant == "as shipped")


@pytest.mark.parametrize("variant", list(ABL.D128_VARIANTS))
def test_d128_ablation_variants_patch_the_shipped_source(variant):
    """The same for the head dim 128 variants (ring depth, the overlapped
    schedule)."""
    shipped = (CSRC / ABL.SOURCE).read_text()
    src = ABL.patched_sources(ABL.SOURCE, {variant: ABL.D128_VARIANTS[variant]})[variant]
    assert (src == shipped) == (variant == "as shipped")


# -- the "auto" gates on the card (meta tensors) --------------------------------


@pytest.fixture
def launches(monkeypatch):
    """Record the C entries the wrappers launch, in place of a build."""
    seen = []
    monkeypatch.setattr(TK, "launch", lambda name, *args: seen.append(name))
    monkeypatch.setattr(TK, "stream_ptr", lambda t: 0)
    return seen


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


F32, BF16 = torch.float32, torch.bfloat16
P, NC = 1374, 610  # a 518 px frame's tokens, a 2-frame scene context


def _sdpa(dtype, d, impl="auto", grad=False):
    q, k, v = (_meta(1, 4, P, d, dtype=dtype, grad=grad) for _ in range(3))
    return TAC.sdpa(q, k, v, impl=impl)


def _frame_ctx(dtype, d, impl="auto", grad=False):
    H = 4
    cfg = TAT.AttentionConfig(dim=H * d, num_heads=H, impl=impl)
    q, k, v = (_meta(2, H, P, d, dtype=dtype, grad=grad) for _ in range(3))
    ck, cv = _meta(1, H, NC, d, dtype=dtype), _meta(1, H, NC, d, dtype=dtype)
    return TAT.attention_heads_out(None, q, k, v, cfg, extra_kv=(ck, cv))


def _reloc_split(dtype, d, impl="auto", grad=False):
    H = 4
    cfg = TAT.AttentionConfig(dim=H * d, num_heads=H, impl=impl)
    q, k, v = (_meta(1, H, 2 * P, d, dtype=dtype, grad=grad) for _ in range(3))
    ck, cv = _meta(1, H, NC, d, dtype=dtype), _meta(1, H, NC, d, dtype=dtype)
    return TAT.attention_heads_out(None, q, k, v, cfg, mask=RelocMask(NC, P, 2),
                                   extra_kv=(ck, cv))


def _masked_sdpa(dtype, d, impl="auto", grad=False):
    """sdpa under a RelocMask, the train site's reloc layer 0: K1m."""
    mask = RelocMask(NC, P, 2)
    q = _meta(1, 4, mask.nq, d, dtype=dtype, grad=grad)
    k, v = (_meta(1, 4, mask.nk, d, dtype=dtype, grad=grad) for _ in range(2))
    return TAC.sdpa(q, k, v, mask, impl=impl)


def _packed(dtype, d, impl="auto", grad=False, cache_dtype=None):
    q, k, v = (_meta(2, 4, P, d, dtype=dtype, grad=grad) for _ in range(3))
    ckv = _meta(3, 1, 4, NC, 2 * d, dtype=cache_dtype or dtype)
    return TFA.packed_ctx_attention(q, k, v, ckv, 1, impl=impl)


# gate -> (site, its bf16 launches, its fp32 launches without grad under
# "auto")
GATES = {"sdpa": (_sdpa, ["sfm_flash_fwd_bf16"], ["sfm_flash_fwd_f32"]),
         "frame-context": (_frame_ctx, ["sfm_frame_ctx_fwd_bf16"], ["sfm_frame_ctx_fwd_f32"]),
         "reloc split": (_reloc_split, ["sfm_flash_fwd_bf16"] * 2, ["sfm_flash_fwd_f32"] * 2),
         "masked sdpa": (_masked_sdpa, ["sfm_flash_fwd_reloc_sm90"], ["sfm_flash_fwd_reloc_f32"]),
         "packed cache": (_packed, ["sfm_frame_ctx_kv2_fwd_bf16"],
                          ["sfm_frame_ctx_kv2_fwd_f32"])}
_DQ, _DKV = "sfm_flash_bwd_dq_f32", "sfm_flash_bwd_dkv_f32"
# gate -> the fp32 launches of its forward and backward under grad: B9's
# fp32 pair a flash call (the frame-context site's backward is the VJP of
# its split, two K1 calls recomputed); K2p has no backward, so the packed
# cache's differentiated site runs dense
GRAD_GATES = {
    "sdpa": ["sfm_flash_fwd_f32", _DQ, _DKV],
    "frame-context": ["sfm_frame_ctx_fwd_f32"] + ["sfm_flash_fwd_f32"] * 2 + [_DQ, _DKV] * 2,
    "reloc split": ["sfm_flash_fwd_f32"] * 2 + [_DQ, _DKV] * 2,
    "masked sdpa": ["sfm_flash_fwd_reloc_f32", "sfm_flash_bwd_dq_reloc_f32",
                    "sfm_flash_bwd_dkv_reloc_f32"],
    "packed cache": []}


@pytest.mark.parametrize("dtype,d,grad", [(F32, 32, True), (BF16, 32, False), (F32, 32, False),
                                          (BF16, 96, True), (F32, 96, True),
                                          (F32, 256, False)])
@pytest.mark.parametrize("gate", list(GATES))
def test_auto_routes_sites_the_kernels_do_not_take_dense(launches, gate, dtype, d, grad):
    """Off the CPU, a head dim without a kernel in either dtype (32, 96,
    256), with or without grad: the dense route, no launch, the output of
    the site's shape and dtype."""
    out = GATES[gate][0](dtype, d, grad=grad)
    assert launches == []
    assert out.device.type == "meta" and out.dtype == dtype and out.shape[-1] == d


@pytest.mark.parametrize("gate", list(GRAD_GATES))
def test_auto_routes_fp32_grad_sites_to_the_fp32_entries(launches, gate):
    """fp32 of head dim 64 that autograd differentiates: the forward on the
    fp32 forms (K1, K1m, K2) and the backward on B9's fp32 entries (the
    RelocMask ones under a mask), launched as a backward through the site
    lists them; no dense route but the packed cache's, which has no
    backward kernel."""
    with torch.enable_grad():
        out = GATES[gate][0](F32, 64, grad=True)
        assert out.requires_grad
        out.sum().backward()
    assert launches == GRAD_GATES[gate]
    assert out.dtype == F32 and out.shape[-1] == 64


@pytest.mark.parametrize("gate", list(GATES))
def test_auto_routes_bf16_sites_to_the_kernels(launches, gate):
    out = GATES[gate][0](BF16, 64)
    assert launches == GATES[gate][1]
    assert out.dtype == BF16


# gate -> its launches at head dim 128 in bf16 without grad under "auto"
D128_GATES = {"sdpa": ["sfm_flash_fwd_d128_bf16"],
              "frame-context": ["sfm_frame_ctx_fwd_d128_bf16"],
              "reloc split": ["sfm_flash_fwd_d128_bf16"] * 2,
              "masked sdpa": ["sfm_flash_fwd_reloc_d128_sm90"],
              "packed cache": ["sfm_frame_ctx_kv2_fwd_d128_bf16"]}


@pytest.mark.parametrize("gate", list(D128_GATES))
def test_auto_routes_bf16_d128_sites_to_the_d128_entries(launches, gate):
    """bf16 of head dim 128 that autograd does not differentiate: the head
    dim 128 forms of K1, K2, K2p and, under a RelocMask, K1m."""
    out = GATES[gate][0](BF16, 128)
    assert launches == D128_GATES[gate]
    assert out.dtype == BF16 and out.shape[-1] == 128


@pytest.mark.parametrize("dtype,d,grad", [(F32, 96, True), (F32, 256, False),
                                          (BF16, 96, True)])
@pytest.mark.parametrize("gate", list(GATES))
def test_explicit_flash_at_d128_meets_the_refusal(launches, gate, dtype, d, grad):
    """impl="flash" where no kernel exists (fp32 at head dim 96, a site
    autograd differentiates, or 256 without grad; bf16 at head dim 96 with
    grad: the kernels take 64 or 128 in either dtype) raises before any
    launch, and is not turned into the dense route; the packed cache under
    grad meets its bare wrapper's refusal, as at head dim 64."""
    with torch.enable_grad():
        if gate == "packed cache" and grad:
            with pytest.raises(NotImplementedError, match="not differentiable"):
                GATES[gate][0](dtype, d, impl="flash", grad=grad)
        else:
            kind = f"{str(dtype).removeprefix('torch.')} {'backward ' if grad else ''}kernels"
            with pytest.raises(ValueError, match=f"{kind} take head dim 64 or 128, got {d}"):
                GATES[gate][0](dtype, d, impl="flash", grad=grad)
    assert launches == []


def test_kernel_takes_at_d128():
    """The predicate itself on meta tensors: bf16 and fp32 of head dim 128,
    with or without grad (on q, k, v or the context passed beside them);
    not with operands of two dtypes; bf16 or fp32 of head dim 96 with grad
    not."""
    q = _meta(1, 2, 8, 128)
    assert TFA.kernel_takes(q, q, q)
    assert TFA.kernel_takes(q, q, q, _meta(1, 2, 8, 128, grad=True))
    assert TFA.kernel_takes(_meta(1, 2, 8, 128, grad=True), q, q)
    with torch.no_grad():
        assert TFA.kernel_takes(_meta(1, 2, 8, 128, grad=True), q, q)
    q32 = _meta(1, 2, 8, 128, dtype=F32)
    assert TFA.kernel_takes(q32, q32, q32)
    assert TFA.kernel_takes(*(_meta(1, 2, 8, 128, dtype=F32, grad=True),) * 3)
    assert TFA.kernel_takes(q32, q32, q32, _meta(1, 2, 8, 128, dtype=F32, grad=True))
    assert not TFA.kernel_takes(q, q, q32)
    assert not TFA.kernel_takes(q32, q32, q)
    assert not TFA.kernel_takes(*(_meta(1, 2, 8, 96, grad=True),) * 3)
    assert not TFA.kernel_takes(*(_meta(1, 2, 8, 96, dtype=F32, grad=True),) * 3)
    assert TFA.kernel_takes(*(_meta(1, 2, 8, 64, dtype=F32, grad=True),) * 3)


_DQ128, _DKV128 = "sfm_flash_bwd_dq_d128_sm90", "sfm_flash_bwd_dkv_d128_sm90"
# gate -> the launches of its forward and backward under grad at head dim
# 128 in bf16: the head dim 128 entries of K1 / K1m / K2 and of B9; K2p has
# no backward, so the packed cache's differentiated site runs dense
D128_GRAD_GATES = {
    "sdpa": ["sfm_flash_fwd_d128_bf16", _DQ128, _DKV128],
    "frame-context": ["sfm_frame_ctx_fwd_d128_bf16"] + ["sfm_flash_fwd_d128_bf16"] * 2
                     + [_DQ128, _DKV128] * 2,
    "reloc split": ["sfm_flash_fwd_d128_bf16"] * 2 + [_DQ128, _DKV128] * 2,
    "masked sdpa": ["sfm_flash_fwd_reloc_d128_sm90", "sfm_flash_bwd_dq_reloc_d128_sm90",
                    "sfm_flash_bwd_dkv_reloc_d128_sm90"],
    "packed cache": []}


@pytest.mark.parametrize("gate", list(D128_GRAD_GATES))
def test_auto_routes_bf16_d128_grad_sites_to_the_d128_entries(launches, gate):
    """bf16 of head dim 128 that autograd differentiates: the forward on the
    head dim 128 forms and the backward on B9's head dim 128 entries (the
    RelocMask ones under a mask), launched as a backward through the site
    lists them; the packed cache alone dense."""
    with torch.enable_grad():
        out = GATES[gate][0](BF16, 128, grad=True)
        assert out.requires_grad
        out.sum().backward()
    assert launches == D128_GRAD_GATES[gate]
    assert out.dtype == BF16 and out.shape[-1] == 128


def test_ring_gate_takes_a_bf16_d128_chunk_under_grad():
    """The ring's ``_use_flash`` asks ``kernel_takes`` with grad: a bf16 or
    an fp32 chunk of head dim 128 that autograd differentiates takes K1 (and
    B9 in its backward), a chunk at 96 in either dtype the dense chunk, as
    does every CPU chunk and ``"dense"``."""
    from self_supervise_sfm_tpu_torch.ops import ring_attention as TRA

    with torch.enable_grad():
        bf = [_meta(1, 2, 64, 128, grad=True) for _ in range(3)]
        assert TRA._use_flash(*bf)
        assert not TRA._use_flash(*bf, impl="dense")
        assert TRA._use_flash(*(_meta(1, 2, 64, 128, dtype=F32, grad=True),) * 3)
        assert not TRA._use_flash(*(_meta(1, 2, 64, 96, grad=True),) * 3)
        assert not TRA._use_flash(*(_meta(1, 2, 64, 96, dtype=F32, grad=True),) * 3)
        assert not TRA._use_flash(*(torch.zeros(1, 2, 64, 128, dtype=BF16),) * 3)


# gate -> its launches at head dim 128 in fp32 without grad under "auto": the
# FFMA bodies' head dim 128 entries
D128_F32_GATES = {"sdpa": ["sfm_flash_fwd_d128_f32"],
                  "frame-context": ["sfm_frame_ctx_fwd_d128_f32"],
                  "reloc split": ["sfm_flash_fwd_d128_f32"] * 2,
                  "masked sdpa": ["sfm_flash_fwd_reloc_d128_f32"],
                  "packed cache": ["sfm_frame_ctx_kv2_fwd_d128_f32"]}
_DQ128F, _DKV128F = "sfm_flash_bwd_dq_d128_f32", "sfm_flash_bwd_dkv_d128_f32"
# gate -> the launches of its forward and backward under grad at head dim
# 128 in fp32 (the packed cache, which has no backward, dense)
D128_F32_GRAD_GATES = {
    "sdpa": ["sfm_flash_fwd_d128_f32", _DQ128F, _DKV128F],
    "frame-context": ["sfm_frame_ctx_fwd_d128_f32"] + ["sfm_flash_fwd_d128_f32"] * 2
                     + [_DQ128F, _DKV128F] * 2,
    "reloc split": ["sfm_flash_fwd_d128_f32"] * 2 + [_DQ128F, _DKV128F] * 2,
    "masked sdpa": ["sfm_flash_fwd_reloc_d128_f32", "sfm_flash_bwd_dq_reloc_d128_f32",
                    "sfm_flash_bwd_dkv_reloc_d128_f32"],
    "packed cache": []}
_WRAPPERS = (TFA.flash_fwd, TFA.flash_fwd_reloc, TFA.frame_ctx_fwd, TFA.frame_ctx_packed_fwd,
             TFA.flash_bwd_dq, TFA.flash_bwd_dkv)
_COUNTERS = ("launches", "launches_f32", "launches_d128", "launches_d128_f32")


def _counts():
    return {c: sum(getattr(w, c) for w in _WRAPPERS) for c in _COUNTERS}


@pytest.mark.parametrize("gate", list(D128_F32_GATES))
def test_auto_routes_fp32_d128_sites_to_the_d128_f32_entries(launches, gate):
    """fp32 of head dim 128 that autograd does not differentiate: the head
    dim 128 forms of K1, K2, K2p and, under a RelocMask, K1m on the FFMA
    body, each launch counted in ``.launches_d128_f32`` alone; the entries
    are registered with the library."""
    n0 = _counts()
    out = GATES[gate][0](F32, 128)
    assert launches == D128_F32_GATES[gate]
    assert out.dtype == F32 and out.shape[-1] == 128
    n1 = _counts()
    assert {c: n1[c] - n0[c] for c in _COUNTERS} == dict(
        launches=0, launches_f32=0, launches_d128=0, launches_d128_f32=len(launches))
    assert all(e in TK._SIGNATURES for e in launches)


@pytest.mark.parametrize("gate", list(D128_F32_GRAD_GATES))
def test_auto_routes_fp32_d128_grad_sites_to_the_d128_f32_entries(launches, gate):
    """fp32 of head dim 128 that autograd differentiates: the forward on the
    fp32 head dim 128 forms and the backward on B9's fp32 head dim 128
    entries (the RelocMask ones under a mask), counted apart; the packed
    cache alone dense."""
    n0 = _counts()
    with torch.enable_grad():
        out = GATES[gate][0](F32, 128, grad=True)
        assert out.requires_grad
        out.sum().backward()
    assert launches == D128_F32_GRAD_GATES[gate]
    assert out.dtype == F32 and out.shape[-1] == 128
    assert _counts()["launches_d128_f32"] - n0["launches_d128_f32"] == len(launches)
    assert all(e in TK._SIGNATURES for e in launches)


@pytest.mark.parametrize("gate", list(GATES))
def test_auto_routes_fp32_sites_without_grad_to_the_fp32_entries(launches, gate):
    """fp32 of head dim 64 that autograd does not differentiate: the fp32
    forms of K1, K2, K2p and, under a RelocMask, K1m."""
    out = GATES[gate][0](F32, 64)
    assert launches == GATES[gate][2]
    assert out.dtype == F32 and out.shape[-1] == 64


@pytest.mark.parametrize("gate", list(GATES))
def test_explicit_flash_with_fp32_meets_the_kernels_refusal(launches, gate):
    """impl="flash" on an fp32 site that autograd differentiates launches
    the fp32 forward entries, whose backward kernels exist; the packed cache
    alone meets the refusal of its bare wrapper (K2p has no backward), and
    is not turned into the dense route."""
    with torch.enable_grad():
        if gate == "packed cache":
            with pytest.raises(NotImplementedError, match="not differentiable"):
                GATES[gate][0](F32, 64, impl="flash", grad=True)
        else:
            assert GATES[gate][0](F32, 64, impl="flash", grad=True).requires_grad
    assert launches == ([] if gate == "packed cache" else GATES[gate][2])


@pytest.mark.parametrize("gate", list(GATES))
def test_explicit_flash_with_fp32_without_grad_launches(launches, gate):
    """impl="flash" on an fp32 site without grad reaches the fp32 entries,
    K1m's under a RelocMask."""
    assert GATES[gate][0](F32, 64, impl="flash").dtype == F32
    assert launches == GATES[gate][2]


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_fp32_q_against_a_bf16_cache(launches, impl):
    """K2p reads the cache in place, in q's dtype: an fp32 q against a bf16
    cache runs dense under "auto" and raises under "flash"."""
    if impl == "flash":
        with pytest.raises(TypeError, match="the cache must be torch.float32"):
            _packed(F32, 64, impl=impl, cache_dtype=BF16)
    else:
        assert _packed(F32, 64, impl=impl, cache_dtype=BF16).dtype == F32
    assert launches == []


def test_kernel_takes_any_cpu_tensor():
    """On the CPU the wrappers run their dtype-generic plain versions, so the
    gates take every site, as before."""
    for dtype, d in ((F32, 64), (BF16, 64), (F32, 32)):
        q = torch.zeros((1, 1, 4, d), dtype=dtype)
        assert TFA.kernel_takes(q, q, q)
    assert TFA.worth_it(*(torch.zeros((1, 1, 1225, 64)),) * 3)
    assert not TFA.worth_it(*(torch.zeros((1, 1, 1224, 64)),) * 3)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_bwd_routes_fp32_d128_to_the_d128_f32_entries(launches, masked):
    """At head dim 128 in fp32 the backward reaches the FFMA body's head
    dim 128 entries, unmasked or under a RelocMask, and each wrapper counts
    the launch in ``.launches_d128_f32`` alone."""
    bh, nq, d = 2, 2 * 130, 128
    mask = RelocMask(77, 130, 2) if masked else None
    nk = nq + 77 if masked else 200
    q, do, o = (_meta(bh, nq, d, dtype=F32) for _ in range(3))
    k, v = _meta(bh, nk, d, dtype=F32), _meta(bh, nk, d, dtype=F32)
    lse = _meta(bh, nq, dtype=F32)
    n0 = [getattr(w, c) for w in (TFA.flash_bwd_dq, TFA.flash_bwd_dkv) for c in _COUNTERS]
    dq, dk, dv = TFA.flash_bwd(q, k, v, o, lse, do, None, mask)
    want = "reloc_d128_f32" if masked else "d128_f32"
    assert launches == [f"sfm_flash_bwd_dq_{want}", f"sfm_flash_bwd_dkv_{want}"]
    n1 = [getattr(w, c) for w in (TFA.flash_bwd_dq, TFA.flash_bwd_dkv) for c in _COUNTERS]
    assert n1 == [a + b for a, b in zip(n0, [0, 0, 0, 1] * 2)]
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert dq.dtype == dk.dtype == dv.dtype == F32
    assert all(e in TK._SIGNATURES for e in launches)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_bwd_routes_d128_to_the_d128_entries(launches, masked):
    """At head dim 128 in bf16 the backward reaches the head dim 128 entries
    of the Hopper body, unmasked or under a RelocMask, and each wrapper
    counts the launch in ``.launches_d128`` alone."""
    bh, nq, d = 2, 2 * 130, 128
    mask = RelocMask(77, 130, 2) if masked else None
    nk = nq + 77 if masked else 200
    q, do, o = (_meta(bh, nq, d) for _ in range(3))
    k, v = _meta(bh, nk, d), _meta(bh, nk, d)
    lse = _meta(bh, nq, dtype=F32)
    counters = ("launches", "launches_f32", "launches_d128")
    n0 = [getattr(w, c) for w in (TFA.flash_bwd_dq, TFA.flash_bwd_dkv) for c in counters]
    dq, dk, dv = TFA.flash_bwd(q, k, v, o, lse, do, None, mask)
    want = "reloc_d128_sm90" if masked else "d128_sm90"
    assert launches == [f"sfm_flash_bwd_dq_{want}", f"sfm_flash_bwd_dkv_{want}"]
    n1 = [getattr(w, c) for w in (TFA.flash_bwd_dq, TFA.flash_bwd_dkv) for c in counters]
    assert n1 == [a + b for a, b in zip(n0, [0, 0, 1] * 2)]
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert dq.dtype == dk.dtype == dv.dtype == BF16
    assert all(e in TK._SIGNATURES for e in (f"sfm_flash_bwd_dq_{want}",
                                             f"sfm_flash_bwd_dkv_{want}"))


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_bwd_routes_by_mask(launches, masked, dtype):
    """An unmasked backward reaches the unmasked entries, a RelocMask its
    RelocMask entries: the Hopper body's in bf16, the FFMA body's in fp32;
    each wrapper counts its launch, fp32 apart in ``.launches_f32``."""
    bh, nq = 2, 2 * 130
    mask = RelocMask(77, 130, 2) if masked else None
    nk = nq + 77 if masked else 200
    q, do, o = (_meta(bh, nq, D, dtype=dtype) for _ in range(3))
    k, v = _meta(bh, nk, D, dtype=dtype), _meta(bh, nk, D, dtype=dtype)
    lse = _meta(bh, nq, dtype=F32)
    counters = ("launches", "launches_f32")
    n0 = [getattr(w, c) for w in (TFA.flash_bwd_dq, TFA.flash_bwd_dkv) for c in counters]
    dq, dk, dv = TFA.flash_bwd(q, k, v, o, lse, do, None, mask)
    body = "sm90" if dtype == BF16 else "f32"
    want = f"reloc_{body}" if masked else body
    assert launches == [f"sfm_flash_bwd_dq_{want}", f"sfm_flash_bwd_dkv_{want}"]
    n1 = [getattr(w, c) for w in (TFA.flash_bwd_dq, TFA.flash_bwd_dkv) for c in counters]
    step = [1, 0] if dtype == BF16 else [0, 1]
    assert n1 == [a + b for a, b in zip(n0, step * 2)]
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert dq.dtype == dk.dtype == dv.dtype == dtype


def test_flash_bwd_with_no_keys_or_rows_launches_nothing(launches):
    """With no key dq is 0, with no q row dk and dv are: nothing to launch."""
    q, k = _meta(2, 5, D), _meta(2, 0, D)
    lse = _meta(2, 5, dtype=F32)
    TFA.flash_bwd_dq(q, k, k, q, lse, lse)
    q0, k0 = _meta(2, 0, D), _meta(2, 7, D)
    lse0 = _meta(2, 0, dtype=F32)
    TFA.flash_bwd_dkv(q0, k0, k0, q0, lse0, lse0)
    assert launches == []
