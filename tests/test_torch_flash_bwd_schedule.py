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
``sdpa``, the frame-context gate, the reloc-split gate and
``packed_ctx_attention`` sends fp32 sites and head dims other than 64 to the
dense path and bf16 sites to the kernels; ``impl="flash"`` with fp32 still
meets the kernel's refusal; ``flash_bwd`` reaches the Hopper body's
unmasked entries, or its RelocMask entries with a mask.
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


def _scales():
    """The wrapper's fp32 scale * log2(e) and scale, as ctypes passes them."""
    return (np.float32(D**-0.5 * LOG2E), np.float32(D**-0.5))


def _lse2(lse):
    return lse.float() * torch.tensor(np.float32(LOG2E))


def _pad(x, n0, n):
    """Rows [n0, n0 + n) of (S, N, ...) x, zero-filled past N (a TMA box)."""
    out = torch.zeros((x.shape[0], n, *x.shape[2:]), dtype=x.dtype)
    valid = max(0, min(n, x.shape[1] - n0))
    out[:, :valid] = x[:, n0:n0 + valid]
    return out, valid


def _emulate_dkv(q, k, v, do, lse, delta):
    """dk, dv as the dk/dv kernel computes them: q tiles of KV_BQ in order."""
    c, scale = _scales()
    S, nq, d = q.shape
    nk = k.shape[1]
    lse2 = _lse2(lse)
    dk = torch.zeros((S, nk, d))
    dv = torch.zeros((S, nk, d))
    for q0 in range(0, nq, KV_BQ):
        qt, valid = _pad(q, q0, KV_BQ)
        dot, _ = _pad(do, q0, KV_BQ)
        l2, _ = _pad(lse2, q0, KV_BQ)
        dl, _ = _pad(delta.float(), q0, KV_BQ)
        st = torch.matmul(k.float(), qt.float().transpose(-1, -2))  # S^T (S, nk, BQ)
        dpt = torch.matmul(v.float(), dot.float().transpose(-1, -2))
        p = _exp2_ftz(_ffma(st, c, l2[:, None, :]))
        p[..., valid:] = 0.0
        ds = p * (dpt - dl[:, None, :]) * torch.tensor(scale)
        dv = dv + torch.matmul(p.to(torch.bfloat16).float(), dot.float())
        dk = dk + torch.matmul(ds.to(torch.bfloat16).float(), qt.float())
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _emulate_dq(q, k, v, do, lse, delta):
    """dq as the dq kernel computes it: key tiles of DQ_BK in order."""
    c, scale = _scales()
    S, nq, d = q.shape
    nk = k.shape[1]
    lse2 = _lse2(lse)
    dq = torch.zeros((S, nq, d))
    for k0 in range(0, nk, DQ_BK):
        kt, valid = _pad(k, k0, DQ_BK)
        vt, _ = _pad(v, k0, DQ_BK)
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


# (nq, nk, with an lse cotangent): ragged q and key tiles on both sides, and
# the split context's shape, fewer keys than q rows
CASES = {"130x77": (130, 77, False), "130x77_dlse": (130, 77, True),
         "257x130": (257, 130, False), "257x130_dlse": (257, 130, True),
         "context_300x140_dlse": (300, 140, True)}


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(13)
    out = {}
    for name, (nq, nk, with_dlse) in CASES.items():
        (jq, tq), (jdo, tdo) = (_bf16_pair(rng, (2, nq, D)) for _ in range(2))
        (jk, tk), (jv, tv) = (_bf16_pair(rng, (2, nk, D)) for _ in range(2))
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


def _dq_key_tiles(p: dict, w):
    """dq_key_tile over a work tile's steps: (k0, end) of each key tile."""
    ctx = _cdiv(p["n_ctx"], DQ_BK)
    for i in range(ctx + _cdiv(w[4] - w[3], DQ_BK)):
        k0 = i * DQ_BK if i < ctx else w[3] + (i - ctx) * DQ_BK
        yield k0, min(k0 + DQ_BK, p["n_ctx"] if i < ctx else w[4])


def _kv_q_tiles(w):
    """The q tiles a dk/dv work tile streams: (q0, end of its rows)."""
    return [(q0, min(q0 + KV_BQ, w[4])) for q0 in range(w[3], w[4], KV_BQ)]


def _emulate_dkv_masked(q, k, v, do, lse, delta, mask):
    """dk, dv as the RelocMask dk/dv kernel computes them: each work tile's
    keys against its q rows in tiles of KV_BQ, in order (one slice's walk;
    every slice alike)."""
    c, scale = _scales()
    S, nq, d = q.shape
    nk = k.shape[1]
    lse2 = _lse2(lse)
    dk, dv = torch.zeros((S, nk, d)), torch.zeros((S, nk, d))
    p = _params(1, nq, nk, mask, "dkv")
    for t in range(p["tiles"]):
        w = _dkv_work(p, t, True)
        k0, k_end = w[1], w[2]
        kt, vt = k[:, k0:k_end].float(), v[:, k0:k_end].float()
        for q0, q1 in _kv_q_tiles(w):
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
    c, scale = _scales()
    S, nq, d = q.shape
    nk = k.shape[1]
    lse2 = _lse2(lse)
    dq = torch.zeros((S, nq, d))
    p = _params(1, nq, nk, mask, "dq")
    for t in range(p["tiles"]):
        w = _dq_work(p, t, True)
        q0, q1 = w[1], w[2]
        qt, dot = q[:, q0:q1].float(), do[:, q0:q1].float()
        for k0, k1 in _dq_key_tiles(p, w):
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


@pytest.fixture(scope="module")
def masked_cases():
    rng = np.random.default_rng(17)
    out = {}
    for name in MASKED_CASES:
        n_ctx, fs, nf = MASKS[name.removesuffix("_dlse")]
        mask, jmask = RelocMask(n_ctx, fs, nf), JRelocMask(n_ctx, fs, nf)
        (jq, tq), (jdo, tdo) = (_bf16_pair(rng, (2, mask.nq, D)) for _ in range(2))
        (jk, tk), (jv, tv) = (_bf16_pair(rng, (2, mask.nk, D)) for _ in range(2))
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
                for q0, q1 in _kv_q_tiles(w):
                    visits[sl, q0:q1, k0:k_end] += 1
            else:
                w = _dq_work(p, t, True)
                sl, k0, k_end = w[0], w[1], w[2]
                assert k_end - k0 <= DQ_BM
                for kt0, kt1 in _dq_key_tiles(p, w):
                    assert kt1 - kt0 <= DQ_BK
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
                 "const bool edge = edge_k || q0 + KV_BQ > w.s_end;"):
        assert line in SOURCE, line
    assert "< p.nk" not in SOURCE.split("// -- host side")[0]


# -- the source: constants, tiles, rounds, the ring and the turns --------------

# the train step's sites (BH, Nq, Nk)
SITES = {"vit": (32, 1374, 1374), "frame": (64, 1374, 1374), "global": (16, 2748, 2748),
         "split own": (32, 1374, 1374), "split context": (32, 1374, 610)}


def test_constants_tiles_and_shared_memory():
    """The source's tiles, its shared memory inside the 227 KB a block may
    take, and the work tiles and rounds of 132 multiprocessors its header
    quotes."""
    assert (KV_BM, KV_BQ, DQ_BM, DQ_BK, KV_STAGES, DQ_STAGES) == (128, 64, 128, 128, 3, 3)
    row = D * 2
    kv_smem = 1024 + 4 * KV_BM * row + KV_STAGES * (2 * KV_BQ * row + 2 * KV_BQ * 4) + (
        2 * KV_STAGES + 4) * 8
    dq_smem = 1024 + 2 * DQ_BM * row + DQ_STAGES * 2 * DQ_BK * row + (2 * DQ_STAGES + 2) * 8
    assert kv_smem <= 232448 and dq_smem <= 232448
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
    assert "constexpr int KV_SMEM_BYTES = 1024 + KV_BAR_OFF + static_cast<int>(sizeof(DkvBarriers));" in SOURCE
    assert "constexpr int DQ_SMEM_BYTES = 1024 + DQ_BAR_OFF + static_cast<int>(sizeof(DqBarriers));" in SOURCE
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
    register-A products' default), and the dk/dv kernel's K / V fragments come
    from ldmatrix on the 128-byte swizzle."""
    assert SOURCE.count("wgmma_rs_m64n64(dv, pa[kk], desc_add(ddo, 128 * kk));") == 1
    assert SOURCE.count("wgmma_rs_m64n64(dk, da[kk], desc_add(dq_, 128 * kk));") == 1
    assert SOURCE.count("wgmma_rs_m64n64(dq, da[kk], desc_add(dk_, 128 * kk));") == 1
    assert "(((2 * kk + (lane >> 4)) ^ (row & 7)) << 4)" in SOURCE
    assert "atomicAdd" not in SOURCE and "red.global" not in SOURCE and "atom." not in SOURCE


@pytest.mark.parametrize("variant", list(ABL.BWD_VARIANTS))
def test_bwd_ablation_variants_patch_the_shipped_source(variant):
    """Every backward variant of tools/ablate_attention.py finds each text it
    patches exactly once in the shipped source (the tool checks this on the
    card too, before any build), and changes the source unless it is the
    source."""
    src = ABL.patched_sources(ABL.BWD_SOURCE, {variant: ABL.BWD_VARIANTS[variant]})[variant]
    assert (src == SOURCE) == (variant == "as shipped")


@pytest.mark.parametrize("variant", list(ABL.VARIANTS))
def test_fwd_ablation_variants_patch_the_shipped_source(variant):
    """The same for the forward variants (K1 / K2, flash_fwd_sm90.cu)."""
    shipped = (CSRC / ABL.SOURCE).read_text()
    src = ABL.patched_sources(ABL.SOURCE, {variant: ABL.VARIANTS[variant]})[variant]
    assert (src == shipped) == (variant == "as shipped")


# -- the "auto" gates on the card (meta tensors) --------------------------------


@pytest.fixture
def launches(monkeypatch):
    """Record the C entries the wrappers launch, in place of a build."""
    seen = []
    monkeypatch.setattr(TK, "launch", lambda name, *args: seen.append(name))
    monkeypatch.setattr(TK, "stream_ptr", lambda t: 0)
    return seen


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


F32, BF16 = torch.float32, torch.bfloat16
P, NC = 1374, 610  # a 518 px frame's tokens, a 2-frame scene context


def _sdpa(dtype, d, impl="auto"):
    q, k, v = (_meta(1, 4, P, d, dtype=dtype) for _ in range(3))
    return TAC.sdpa(q, k, v, impl=impl)


def _frame_ctx(dtype, d, impl="auto"):
    H = 4
    cfg = TAT.AttentionConfig(dim=H * d, num_heads=H, impl=impl)
    q, k, v = (_meta(2, H, P, d, dtype=dtype) for _ in range(3))
    ck, cv = _meta(1, H, NC, d, dtype=dtype), _meta(1, H, NC, d, dtype=dtype)
    return TAT.attention_heads_out(None, q, k, v, cfg, extra_kv=(ck, cv))


def _reloc_split(dtype, d, impl="auto"):
    H = 4
    cfg = TAT.AttentionConfig(dim=H * d, num_heads=H, impl=impl)
    q, k, v = (_meta(1, H, 2 * P, d, dtype=dtype) for _ in range(3))
    ck, cv = _meta(1, H, NC, d, dtype=dtype), _meta(1, H, NC, d, dtype=dtype)
    return TAT.attention_heads_out(None, q, k, v, cfg, mask=RelocMask(NC, P, 2),
                                   extra_kv=(ck, cv))


def _packed(dtype, d, impl="auto"):
    q, k, v = (_meta(2, 4, P, d, dtype=dtype) for _ in range(3))
    ckv = _meta(3, 1, 4, NC, 2 * d, dtype=dtype)
    return TFA.packed_ctx_attention(q, k, v, ckv, 1, impl=impl)


GATES = {"sdpa": (_sdpa, ["sfm_flash_fwd_bf16"]),
         "frame-context": (_frame_ctx, ["sfm_frame_ctx_fwd_bf16"]),
         "reloc split": (_reloc_split, ["sfm_flash_fwd_bf16"] * 2),
         "packed cache": (_packed, ["sfm_frame_ctx_kv2_fwd_bf16"])}


@pytest.mark.parametrize("dtype,d", [(F32, 64), (BF16, 32), (F32, 32)])
@pytest.mark.parametrize("gate", list(GATES))
def test_auto_routes_sites_the_kernels_do_not_take_dense(launches, gate, dtype, d):
    """fp32 or head dim other than 64 off the CPU: the dense route, no
    launch, the output of the site's shape and dtype."""
    out = GATES[gate][0](dtype, d)
    assert launches == []
    assert out.device.type == "meta" and out.dtype == dtype and out.shape[-1] == d


@pytest.mark.parametrize("gate", list(GATES))
def test_auto_routes_bf16_sites_to_the_kernels(launches, gate):
    out = GATES[gate][0](BF16, 64)
    assert launches == GATES[gate][1]
    assert out.dtype == BF16


@pytest.mark.parametrize("gate", list(GATES))
def test_explicit_flash_with_fp32_meets_the_kernels_refusal(launches, gate):
    """impl="flash" asks for a kernel that takes no fp32: it raises, and is
    not turned into the dense route."""
    with pytest.raises(TypeError, match="bfloat16"):
        GATES[gate][0](F32, 64, impl="flash")
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
def test_flash_bwd_routes_by_mask(launches, masked):
    """An unmasked backward reaches the Hopper body's unmasked entries, a
    RelocMask its RelocMask entries; each wrapper counts its launch."""
    bh, nq = 2, 2 * 130
    mask = RelocMask(77, 130, 2) if masked else None
    nk = nq + 77 if masked else 200
    q, do, o = _meta(bh, nq, D), _meta(bh, nq, D), _meta(bh, nq, D)
    k, v = _meta(bh, nk, D), _meta(bh, nk, D)
    lse = _meta(bh, nq, dtype=F32)
    n0 = (TFA.flash_bwd_dq.launches, TFA.flash_bwd_dkv.launches)
    dq, dk, dv = TFA.flash_bwd(q, k, v, o, lse, do, None, mask)
    want = ("reloc_sm90" if masked else "sm90")
    assert launches == [f"sfm_flash_bwd_dq_{want}", f"sfm_flash_bwd_dkv_{want}"]
    assert (TFA.flash_bwd_dq.launches, TFA.flash_bwd_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


def test_flash_bwd_with_no_keys_or_rows_launches_nothing(launches):
    """With no key dq is 0, with no q row dk and dv are: nothing to launch."""
    q, k = _meta(2, 5, D), _meta(2, 0, D)
    lse = _meta(2, 5, dtype=F32)
    TFA.flash_bwd_dq(q, k, k, q, lse, lse)
    q0, k0 = _meta(2, 0, D), _meta(2, 7, D)
    lse0 = _meta(2, 0, dtype=F32)
    TFA.flash_bwd_dkv(q0, k0, k0, q0, lse0, lse0)
    assert launches == []
