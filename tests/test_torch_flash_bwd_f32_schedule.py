"""The fp32 backward body (B9's dq and dk/dv kernels in fp32, unmasked and
under a RelocMask) and K1m in fp32, emulated on the CPU and held against the
JAX Pallas kernels in fp32 and the port's plain versions; their walks over a
RelocMask; the source's entries; the launches of the fp32 train step's
attention sites.

``csrc/flash_bwd_f32.cu`` runs only on the card. :func:`_emulate_dq` and
:func:`_emulate_dkv` repeat its arithmetic tile by tile in PyTorch, over the
blocks that :func:`_dq_blocks` / :func:`_dkv_blocks` transcribe from the
source's decoders: a dq block owns 64 q rows (of one frame under a mask) and
streams the context's 64-key tiles, then its frame's own; a dk/dv block owns
64 keys (of one segment) and streams its q rows (all of them for a context
tile, its frame's for a frame tile) in 64-row tiles, in order. Every row at
or past a tile's end is zero-filled (its lse and delta 0); p = exp2(s * c -
lse * log2(e)) with lse * log2(e) rounded once in fp32 and one rounding of
the FFMA's argument, flushed to zero below 2^-126 (ex2.approx.ftz),
selected to 0 past the keys' end (and, in dk/dv, past the q rows' end); ds
= p * (dp - delta) * scale; p and ds stay fp32, the sums are fp32 a tile at
a time. It is held against the Pallas ``_flash_bwd`` in fp32 in interpret
mode (on the Pallas forward's own out and lse, as ``test_torch_train_ops.py``
runs it) and against ``flash_bwd_plain``, with the tolerance phase 2 of
``chip_smoke.py`` applies to the fp32 backward on the card: 2e-5 at the
largest |gradient| of each output (``test_torch_attention.py``'s fp32
tolerance against JAX).

K1m in fp32 is K2's walk on ``csrc/flash_fwd_f32.cu``'s body with a slice
per (batch, head, frame): :func:`_k1m_sources` reads each slice's context and
own keys through the address fields its entry sets, and the forward body's
emulation (``test_torch_flash_f32_schedule.py``) runs over them. It is held
against the Pallas ``_flash_fwd`` with the mask in fp32 and
``flash_fwd_plain`` with the mask (out 2e-5 of the largest |out|, lse 1e-5),
and bit-equal to K2's emulation on the unfolded tensors.

At head dim 128 (the cases named "d128-...") the same emulations run with
the tiles the source gives that head dim: dq's 64-key tiles
(``DQ_BK_D128``) and dk/dv's q tiles (``KV_BQ_D128``: 64 rows through one
stage; the order of the sums does not depend on the stages).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.ops import flash_attention as JFA
from self_supervise_sfm_tpu.ops.mask_spec import RelocMask as JRelocMask
from self_supervise_sfm_tpu_torch import _kernels as TK
from self_supervise_sfm_tpu_torch.heads.camera import camera_head, init_camera_head
from self_supervise_sfm_tpu_torch.models import aggregator as TAG
from self_supervise_sfm_tpu_torch.models import sailrecon as TM
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA
from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask
from tests.test_torch_flash_f32_schedule import _emulate

torch.set_num_threads(1)

CSRC = Path(TFA.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "flash_bwd_f32.cu").read_text()
FWD_SOURCE = (CSRC / "flash_fwd_f32.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


BM, BN = _const("BM"), _const("BN")  # rows a block owns, rows a streamed tile
# head dim -> (keys a dq K / V tile, q rows a dk/dv Q / dO tile)
TILES = {64: (BN, BN), 128: (_const("DQ_BK_D128"), _const("KV_BQ_D128"))}
D = 64
LOG2E = 1.4426950408889634
TOL, LSE_TOL = 2e-5, 1e-5


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _exp2_ftz(x: torch.Tensor) -> torch.Tensor:
    p = torch.exp2(x)
    return torch.where(p < 2.0**-126, torch.zeros_like(p), p)


def _ffma(s, c, b):
    """s * c - b with one rounding, as the FFMA (the product exact in fp64)."""
    return (s.double() * float(c) - b.double()).float()


def _scales(d: int = D):
    """The wrapper's fp32 scale * log2(e) and scale, as ctypes passes them."""
    return np.float32(d**-0.5 * LOG2E), torch.tensor(np.float32(d**-0.5))


def _rows(x, r0: int, end: int, n: int = BN):
    """Rows [r0, r0 + n) of (S, N, ...) x, zero at or past ``end`` (the
    cp.async copies of 0 source bytes)."""
    out = torch.zeros((x.shape[0], n, *x.shape[2:]), dtype=x.dtype)
    valid = max(0, min(n, end - r0))
    out[:, :valid] = x[:, r0:r0 + valid]
    return out


# -- the blocks' decoders, transcribed from the source ------------------------


def _params(nq: int, nk: int, mask) -> dict:
    """make_params: without a mask the context is every key and the q rows
    one frame."""
    if mask is None:
        return dict(nq=nq, nk=nk, n_ctx=nk, frame=nq, frames=1)
    return dict(nq=nq, nk=nk, n_ctx=mask.n_ctx, frame=mask.frame_size,
                frames=nq // mask.frame_size)


def _dq_blocks(p: dict, masked: bool, kn: int = BN):
    """dq_body's block x: (q0, q_end, [(k0, end) of each key tile]); ``kn``
    keys a tile."""
    per_frame = _cdiv(p["frame"], BM)
    ctx_tiles = _cdiv(p["n_ctx"], kn)
    for x in range(p["frames"] * per_frame):
        f0 = x // per_frame * p["frame"]
        q0 = f0 + x % per_frame * BM
        own0 = p["n_ctx"] + f0
        tiles = ctx_tiles + (_cdiv(p["frame"], kn) if masked else 0)
        keys = [(t * kn, p["n_ctx"]) if t < ctx_tiles
                else (own0 + (t - ctx_tiles) * kn, own0 + p["frame"]) for t in range(tiles)]
        yield q0, min(q0 + BM, f0 + p["frame"]), keys


def _dkv_blocks(p: dict, masked: bool, qn: int = BN):
    """dkv_body's block x: (k0, k_end, [(r0, s_end) of each q tile]); ``qn``
    q rows a tile."""
    ctx_tiles = _cdiv(p["n_ctx"], BM)
    per_frame = _cdiv(p["frame"], BM)
    own = p["frames"] * per_frame if masked else 0
    for x in range(ctx_tiles + own):
        if not masked or x < ctx_tiles:
            k0, s0, s_end = x * BM, 0, p["nq"]
            k_end = min(k0 + BM, p["n_ctx"])
        else:
            t = x - ctx_tiles
            s0 = t // per_frame * p["frame"]
            s_end = s0 + p["frame"]
            k0 = p["n_ctx"] + s0 + t % per_frame * BM
            k_end = min(k0 + BM, p["n_ctx"] + s_end)
        yield k0, k_end, [(s0 + i * qn, s_end) for i in range(_cdiv(s_end - s0, qn))]


def test_decoders_are_the_sources():
    """The lines the decoders above transcribe, and the launches' grids."""
    for line in (
        "const int f0 = static_cast<int>(blockIdx.x) / per_frame * p.frame;",
        "const int q0 = f0 + static_cast<int>(blockIdx.x) % per_frame * BM;",
        "const int q_end = min(q0 + BM, f0 + p.frame);",
        "const int tiles = ctx_tiles + (MASKED ? cdiv(p.frame, KN) : 0);",
        "return own0 + (t - ctx_tiles) * KN;",
        "s0 = t / per_frame * p.frame;",
        "k0 = p.n_ctx + s0 + t % per_frame * BM;",
        "k_end = min(k0 + BM, p.n_ctx + s_end);",
        "const int tiles = cdiv(s_end - s0, QN);",
        "static constexpr int KN = D == 64 ? BN : DQ_BK_D128;",
        "static constexpr int QN = D == 64 ? BN : KV_BQ_D128;",
        "return launch<D>(masked ? 2 : 0, p, p.frames * cdiv(p.frame, BM), bh, stream);",
        "return launch<D>(masked ? 3 : 1, p, cdiv(p.n_ctx, BM) + own, bh, stream);",
        "p->n_ctx = masked ? n_ctx : nk;",
        "p->frame = masked ? frame_size : nq;",
    ):
        assert SOURCE.count(line) == 1, line


# -- the emulations -------------------------------------------------------------


def _emulate_dq(q, k, v, do, lse, delta, mask=None):
    """dq as the dq kernel computes it, block by block, with the tiles of
    q's head dim."""
    d = q.shape[-1]
    kn = TILES[d][0]
    c, scale = _scales(d)
    lse2 = lse.float() * torch.tensor(np.float32(LOG2E))
    dq = torch.zeros_like(q)
    for q0, q_end, keys in _dq_blocks(_params(q.shape[1], k.shape[1], mask), mask is not None,
                                      kn):
        qt, dot = _rows(q, q0, q_end, BM), _rows(do, q0, q_end, BM)
        l2, dl = _rows(lse2, q0, q_end, BM), _rows(delta, q0, q_end, BM)
        acc = torch.zeros((q.shape[0], BM, d))
        for k0, end in keys:
            kt, vt = _rows(k, k0, end, kn), _rows(v, k0, end, kn)
            p = _exp2_ftz(_ffma(torch.matmul(qt, kt.transpose(-1, -2)), c, l2[..., None]))
            p[..., max(0, end - k0):] = 0.0
            ds = p * (torch.matmul(dot, vt.transpose(-1, -2)) - dl[..., None]) * scale
            acc = acc + torch.matmul(ds, kt)
        dq[:, q0:q_end] = acc[:, :q_end - q0]
    return dq


def _emulate_dkv(q, k, v, do, lse, delta, mask=None):
    """dk, dv as the dk/dv kernel computes them, block by block, with the
    tiles of q's head dim."""
    d = q.shape[-1]
    qn = TILES[d][1]
    c, scale = _scales(d)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0, k_end, tiles in _dkv_blocks(_params(q.shape[1], k.shape[1], mask),
                                        mask is not None, qn):
        kt, vt = _rows(k, k0, k_end, BM), _rows(v, k0, k_end, BM)
        dk_acc, dv_acc = torch.zeros((k.shape[0], BM, d)), torch.zeros((k.shape[0], BM, d))
        for r0, s_end in tiles:
            qt, dot = _rows(q, r0, s_end, qn), _rows(do, r0, s_end, qn)
            l2 = _rows(lse.float(), r0, s_end, qn) * torch.tensor(np.float32(LOG2E))
            dl = _rows(delta, r0, s_end, qn)
            p = _exp2_ftz(_ffma(torch.matmul(kt, qt.transpose(-1, -2)), c, l2[:, None, :]))
            p[:, k_end - k0:] = 0.0
            p[..., max(0, s_end - r0):] = 0.0
            ds = p * (torch.matmul(vt, dot.transpose(-1, -2)) - dl[:, None, :]) * scale
            dv_acc = dv_acc + torch.matmul(p, dot)
            dk_acc = dk_acc + torch.matmul(ds, qt)
        dk[:, k0:k_end] = dk_acc[:, :k_end - k0]
        dv[:, k0:k_end] = dv_acc[:, :k_end - k0]
    return dk, dv


def _f32_pair(rng, shape):
    """The same fp32 values for JAX and for PyTorch."""
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.array(x, dtype=np.float32)


def _assert_close(got, ref, what, lse=False):
    err = float(np.abs(_np(got) - _np(ref)).max())
    tol = LSE_TOL if lse else TOL * float(np.abs(_np(ref)).max())
    assert err <= tol, f"{what}: max abs error {err} over {tol}"


def _case(rng, nq, nk, jmask, mask, dlse_options, d=D):
    """q, k, v, do of head dim ``d`` from ``rng``; the Pallas forward (with
    the mask) and, for each lse cotangent option, the Pallas backward, the
    emulation and the plain version."""
    (jq, tq), (jdo, tdo) = (_f32_pair(rng, (2, nq, d)) for _ in range(2))
    (jk, tk), (jv, tv) = (_f32_pair(rng, (2, nk, d)) for _ in range(2))
    j_out, j_lse = JFA._flash_fwd(jq, jk, jv, jmask, 128, 128, True)
    to, tl = torch.from_numpy(np.array(j_out)), torch.from_numpy(np.array(j_lse))
    out = {"fwd": dict(q=tq, k=tk, v=tv, pallas=(j_out, j_lse))}
    for with_dlse in dlse_options:
        jdlse = jnp.asarray(rng.normal(size=(2, nq)), jnp.float32) if with_dlse else None
        tdlse = None if jdlse is None else torch.from_numpy(np.array(jdlse))
        pallas = JFA._flash_bwd(jq, jk, jv, j_out, j_lse, jdo, jmask, 128, 128, True,
                                dlse=jdlse)
        delta = TFA._delta(to, tdo, tdlse)
        emu = (_emulate_dq(tq, tk, tv, tdo, tl, delta, mask),
               *_emulate_dkv(tq, tk, tv, tdo, tl, delta, mask))
        plain = TFA.flash_bwd_plain(tq, tk, tv, to, tl, tdo, tdlse, mask)
        out[with_dlse] = dict(emu=emu, pallas=pallas, plain=plain)
    return out


# (nq, nk, with an lse cotangent, head dim): ragged q and key tiles on both
# sides, and the split context's shape, fewer keys than q rows; at head dim
# 128 ragged q and key tiles with an lse cotangent
CASES = {"130x77": (130, 77, False, 64), "130x77_dlse": (130, 77, True, 64),
         "257x130": (257, 130, False, 64), "257x130_dlse": (257, 130, True, 64),
         "context_300x140_dlse": (300, 140, True, 64),
         "d128-130x77_dlse": (130, 77, True, 128)}


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(29)
    return {name: _case(rng, nq, nk, None, None, [dl], d)[dl]
            for name, (nq, nk, dl, d) in CASES.items()}


@pytest.mark.parametrize("ref", ["pallas", "plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_f32_bwd_schedule_matches(cases, case, ref):
    for label, got, want in zip(("dq", "dk", "dv"), cases[case]["emu"], cases[case][ref]):
        _assert_close(got, want, f"{case} {label} vs {ref}")


def test_f32_bwd_schedule_is_not_the_plain_arithmetic(cases):
    """The emulation rounds where the kernels round (the FFMA, sums a tile
    at a time), not as the plain version: it differs from it somewhere,
    inside the tolerance."""
    assert any(not torch.equal(a, b) for case in cases.values()
               for a, b in zip(case["emu"], case["plain"]))


# (n_ctx, P, F): context and frame tails at both kinds of boundary, no
# context, one-row frames, whole 64-row segments, the train site's 98-key
# context tail against a frame of 257 rows, and one frame
MASKS = {"77x130x2": (77, 130, 2), "0x130x3": (0, 130, 3), "5x1x7": (5, 1, 7),
         "64x64x2": (64, 64, 2), "98x257x2": (98, 257, 2), "77x130x1": (77, 130, 1)}
# at head dim 128: one RelocMask of 2 frames, its tails ragged for its tiles
D128_MASKS = {"d128-77x130x2": (77, 130, 2)}
MASKED_CASES = [(m, dl) for m in MASKS for dl in (False, True)]
MASKED_CASES += [(m, dl) for m in D128_MASKS for dl in (False, True)]


@pytest.fixture(scope="module")
def masked_cases():
    rng = np.random.default_rng(31)
    out = {}
    for d, masks in ((64, MASKS), (128, D128_MASKS)):
        for name, (n_ctx, fs, nf) in masks.items():
            mask = RelocMask(n_ctx, fs, nf)
            out[name] = _case(rng, mask.nq, mask.nk, JRelocMask(n_ctx, fs, nf), mask,
                              [False, True], d)
            out[name]["mask"] = mask
    return out


@pytest.mark.parametrize("ref", ["pallas", "plain"])
@pytest.mark.parametrize("case", MASKED_CASES,
                         ids=[f"{m}{'_dlse' if dl else ''}" for m, dl in MASKED_CASES])
def test_masked_f32_bwd_schedule_matches(masked_cases, case, ref):
    name, with_dlse = case
    r = masked_cases[name][with_dlse]
    for label, got, want in zip(("dq", "dk", "dv"), r["emu"], r[ref]):
        _assert_close(got, want, f"{name} dlse={with_dlse} {label} vs {ref}")


# the train step's reloc layer 0 and the 5-query mask, one slice each
MASK_SITES = {"reloc layer 0": (610, 1374, 2), "reloc 5 queries": (1525, 1374, 5)}


@pytest.mark.parametrize("case", list(MASKS) + list(MASK_SITES))
def test_masked_walk_visits_each_allowed_pair_once(case):
    """Over the blocks of each kernel: every allowed (q, k) pair is visited
    (loaded and computed) once and no other pair is, so nothing outside the
    allowed pairs is loaded; every q row (dq) and key row (dk/dv) is stored
    by one block."""
    _check_walk(RelocMask(*{**MASKS, **MASK_SITES}[case]), *TILES[64])


@pytest.mark.parametrize("case", list(MASKS) + list(MASK_SITES))
def test_masked_walk_visits_each_allowed_pair_once_d128(case):
    """The same with the head dim 128 tiles read from the source (dq's key
    tiles, dk/dv's q tiles)."""
    _check_walk(RelocMask(*{**MASKS, **MASK_SITES}[case]), *TILES[128])


def _check_walk(mask, kn, qn):
    p = _params(mask.nq, mask.nk, mask)
    allowed = mask.materialize("cpu").reshape(mask.nq, mask.nk).numpy().astype(np.int32)
    dq = np.zeros_like(allowed)
    dq_rows = np.zeros(mask.nq, np.int32)
    for q0, q_end, keys in _dq_blocks(p, True, kn):
        dq_rows[q0:q_end] += 1
        for k0, end in keys:
            dq[q0:q_end, k0:min(k0 + kn, end)] += 1
    dkv = np.zeros_like(allowed)
    dkv_rows = np.zeros(mask.nk, np.int32)
    for k0, k_end, tiles in _dkv_blocks(p, True, qn):
        dkv_rows[k0:k_end] += 1
        for r0, s_end in tiles:
            dkv[r0:min(r0 + qn, s_end), k0:k_end] += 1
    assert np.array_equal(dq, allowed) and np.array_equal(dkv, allowed)
    assert (dq_rows == 1).all() and (dkv_rows == 1).all()


# -- K1m in fp32 ------------------------------------------------------------------


def _k1m_sources(t, mask):
    """Each slice's context rows and own rows of the key tensor ``t`` (BH,
    n_ctx + F P, D), read through the fields sfm_flash_fwd_reloc_f32 (and
    its head dim 128 form) sets: slice s = bh F + f, own rows at k_off + (s
    / kf) k_slice + (s % kf) P D, context rows at (s / heads / frames) heads
    + s % heads slices of c_slice, c_row floats apart."""
    BH, nk, D = t.shape
    F, P, nc = mask.num_frames, mask.frame_size, mask.n_ctx
    f = dict(kf=F, k_off=nc * D, k_slice=nk * D, heads=1, frames=F, c_slice=nk * D, c_row=D)
    flat = t.reshape(-1)
    ctx, own = [], []
    for s in range(BH * F):
        o = f["k_off"] + s // f["kf"] * f["k_slice"] + s % f["kf"] * P * D
        own.append(flat[o:o + P * D].view(P, D))
        c = (s // f["heads"] // f["frames"]) * f["heads"] + s % f["heads"]
        base = c * f["c_slice"]
        ctx.append(flat[base:base + nc * f["c_row"]].view(nc, f["c_row"]))
    return torch.stack(ctx), torch.stack(own)


def _emulate_k1m(q, k, v, mask):
    (ck, own_k), (cv, own_v) = _k1m_sources(k, mask), _k1m_sources(v, mask)
    S = q.shape[0] * mask.num_frames
    out, lse = _emulate(q.reshape(S, mask.frame_size, q.shape[-1]),
                        [(ck, cv), (own_k, own_v)], lse=True)
    return out.reshape(q.shape), lse.reshape(q.shape[:2])


def test_k1m_f32_entry_sets_the_fields_read_here():
    for line in ("p.kf = num_frames;", "p.k_off = static_cast<long long>(n_ctx) * D;",
                 "p.k_slice = static_cast<long long>(nk) * D;",
                 "p.c_slice = static_cast<long long>(nk) * D;", "p.c_row = D;",
                 "p.frames = num_frames;", "return launch<D>(3, p, bh * num_frames, stream);",
                 "const long long own_off = p.k_off + static_cast<long long>(slice / p.kf) * "
                 "p.k_slice +"):
        assert FWD_SOURCE.count(line) >= 1, line


@pytest.mark.parametrize("ref", ["pallas", "plain"])
@pytest.mark.parametrize("name", list(MASKS) + list(D128_MASKS))
def test_k1m_f32_schedule_matches(masked_cases, name, ref):
    fwd, mask = masked_cases[name]["fwd"], masked_cases[name]["mask"]
    out, lse = _emulate_k1m(fwd["q"], fwd["k"], fwd["v"], mask)
    r_out, r_lse = (fwd["pallas"] if ref == "pallas"
                    else TFA.flash_fwd_plain(fwd["q"], fwd["k"], fwd["v"], mask))
    _assert_close(out, r_out, f"K1m fp32 {name} out vs {ref}")
    _assert_close(lse, r_lse, f"K1m fp32 {name} lse vs {ref}", lse=True)


@pytest.mark.parametrize("name", list(MASKS) + list(D128_MASKS))
def test_k1m_f32_is_k2_on_the_unfolded_tensors(masked_cases, name):
    """K1m's slices read the values K2 reads from the unfolded tensors (q
    and the own keys (BH F, P, 64), each frame's scene context broadcast,
    as ``_emulate_frame_ctx`` of the forward's test lays them out), through
    the same walk: the two agree bit for bit (phase 2 of chip_smoke.py holds
    the kernels so)."""
    fwd, mask = masked_cases[name]["fwd"], masked_cases[name]["mask"]
    q, k, v = fwd["q"], fwd["k"], fwd["v"]
    BH, F, P, nc, D = q.shape[0], mask.num_frames, mask.frame_size, mask.n_ctx, q.shape[-1]

    def frames(t):
        return t.reshape(BH * F, P, D)

    def context(t):
        return t[:, None, :nc].expand(BH, F, nc, D).reshape(BH * F, nc, D)

    k2 = _emulate(frames(q), [(context(k), context(v)), (frames(k[:, nc:]), frames(v[:, nc:]))])
    assert torch.equal(_emulate_k1m(q, k, v, mask)[0], k2.reshape(q.shape))


def test_f32_wrappers_on_cpu_are_the_plain_versions():
    """On CPU tensors the fp32 backward and K1m wrappers run their plain
    versions and count no launch."""
    rng = np.random.default_rng(5)
    mask = RelocMask(20, 30, 2)
    q, do = (torch.from_numpy(rng.normal(size=(2, mask.nq, D)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(2, mask.nk, D)).astype(np.float32))
            for _ in range(2))
    counters = [(w, c) for w in (TFA.flash_fwd_reloc, TFA.flash_bwd_dq, TFA.flash_bwd_dkv)
                for c in ("launches", "launches_f32")]
    n0 = [getattr(w, c) for w, c in counters]
    out, lse = TFA.flash_fwd_reloc(q, k, v, mask)
    p_out, p_lse = TFA.flash_fwd_plain(q, k, v, mask)
    assert torch.equal(out, p_out) and torch.equal(lse, p_lse)
    for m in (None, mask):
        got = TFA.flash_bwd(q, k, v, out, lse, do, None, m)
        want = TFA.flash_bwd_plain(q, k, v, out, lse, do, None, m)
        assert all(torch.equal(a, b) and a.dtype == torch.float32 for a, b in zip(got, want))
    assert [getattr(w, c) for w, c in counters] == n0


# -- the source -------------------------------------------------------------------


def test_f32_bwd_source_entries_and_constants():
    """The fp32 B9 entries at head dims 64 and 128 (and the info entry) are
    defined in the source with their bf16 twins' arguments and registered in
    ``_SIGNATURES``, and so is K1m's fp32 entry in the forward body; the
    tiles and shared memory are what the design says (at 128 dk/dv's
    64-row q tiles through two stages would not fit a block); FFMA, no
    tensor-core product, no atomics; the note names the TPU kernels it
    replaces."""
    for hd in ("", "d128_"):
        for name in ("dq", "dkv", "dq_reloc", "dkv_reloc"):
            entry, twin = f"sfm_flash_bwd_{name}_{hd}f32", f"sfm_flash_bwd_{name}_{hd}sm90"
            assert SOURCE.count(f'extern "C" int {entry}(') == 1, entry
            assert TK._SIGNATURES[entry] == TK._SIGNATURES[twin], entry
    assert SOURCE.count('extern "C" int sfm_flash_bwd_f32_info(') == 1
    assert TK._SIGNATURES["sfm_flash_bwd_f32_info"] == [TK._I, TK._P]
    assert FWD_SOURCE.count('extern "C" int sfm_flash_fwd_reloc_f32(') == 1
    assert TK._SIGNATURES["sfm_flash_fwd_reloc_f32"] == TK._SIGNATURES["sfm_flash_fwd_reloc_sm90"]
    assert (BM, BN, _const("NTHREADS")) == (64, 64, 256)
    assert TILES[128] == (64, 64) and _const("KV_STAGES_D128") == 1
    assert "static constexpr int LD = D + 4;" in SOURCE  # rows padded to 68 or 132 floats

    def smem(d, kn, qn, stages):
        ld = d + 4
        dq = (2 * BM * ld + 4 * kn * ld + BM * (kn + 4)) * 4  # Q, dO, K x 2, V x 2, dS
        # K, V, (Q, dO) x stages, P^T, dS^T, (lse, delta) x stages
        dkv = (2 * BM * ld + 2 * stages * qn * ld + 2 * BM * (qn + 4) + stages * 2 * qn) * 4
        return dq, dkv

    assert smem(64, 64, 64, 2) == (121_856, 140_288)
    assert smem(128, 64, 64, 1) == (220_160, 170_496)
    assert smem(128, 64, 64, 2)[1] == 238_592 > 232_448  # 64-row tiles, two stages
    assert smem(128, 64, 32, 2)[1] == 154_112  # the ablation's 32-row tiles
    for line in ("static constexpr int DQ_SMEM_BYTES = (2 * BM * LD + 4 * KN * LD + BM * (KN + 4)) "
                 "* 4;",
                 "(2 * BM * LD + 2 * KV_STAGES * QN * LD + 2 * BM * (QN + 4) + KV_STAGES * 2 * QN) "
                 "* 4;",
                 "float pe = exp2_ftz(fmaf(s[i][j], p.scale_log2, -lse2[i]));",
                 "float pe = exp2_ftz(fmaf(s[i][j], p.scale_log2, -l2));",
                 "pe = k0 + tc + 16 * j < end ? pe : 0.f;",
                 "pe = kok[i] && qok ? pe : 0.f;",
                 "sds[(4 * tr + i) * LDS + tc + 16 * j] = pe * (dp[i][j] - dl[i]) * p.scale;",
                 "sdst[(4 * tr + i) * LDP + c] = pe * (dp[i][j] - dl) * p.scale;",
                 "acc_product<D, KN>(acc, sds, kt, tr, tc);",
                 "acc_product<D, QN>(dv, spt, dot, tr, tc);",
                 "acc_product<D, QN>(dk, sdst, qt, tr, tc);"):
        assert SOURCE.count(line) == 1, line
    for text in (r"wgmma", r"mma\.sync", r"atomicAdd", r"\bred\.global", r"\batom\."):
        assert not re.search(text, SOURCE), text
    for kernel in ("_dq_kernel", "_dkv_kernel"):
        assert kernel in SOURCE


# -- the slice: the fp32 train step's attention sites ---------------------------


def _step_launches(monkeypatch, dtype: str) -> list:
    """The kernel entries one train step's trunk and camera head launch on
    the card (meta tensors at 518 px, two frames duplicated, remat; depth
    cut to 2 aggregator layers and 1 ViT block): the forward, the remat
    recompute and the backward."""
    seen = []
    monkeypatch.setattr(TK, "launch", lambda name, *args: seen.append(name))
    monkeypatch.setattr(TK, "stream_ptr", lambda t: 0)
    cfg = TM.make_config(compute_dtype=dtype, remat=True, depth=2, vit_depth=1,
                         intermediate_layer_idx=(0, 0, 1, 1))
    meta = torch.device("meta")
    p = {"aggregator": TAG.init_aggregator(None, meta, cfg.aggregator),
         "camera_head": init_camera_head(None, meta, cfg.camera)}

    def grad(tree):
        for x in (tree.values() if isinstance(tree, dict) else tree):
            grad(x) if isinstance(x, (dict, list)) else x.requires_grad_(True)

    grad(p)
    S, rank = 2, 300
    images = torch.empty((1, 2 * S, 518, 518, 3), device=meta)
    idx = torch.zeros((2, 1, S, rank), dtype=torch.long, device=meta)
    pc = TM.cast_trunk_weights(p, cfg)
    taps, _, cam = TAG.aggregator_forward(pc["aggregator"], cfg.aggregator, images, S, S,
                                          rank, None, idx, images_duplicated=True)
    camera_head(pc["camera_head"], taps[-1], cam, cfg.camera)[-1].sum().backward()
    return seen


def test_f32_step_launches_the_bf16_steps_attention_list(monkeypatch):
    """The fp32 step's attention launches are the bf16 step's, in the same
    order, with the fp32 entries' names: v + 6 d K1, 2 d K2 and v + 4 d B9
    pairs (d aggregator layers, v ViT blocks); nothing runs dense, and no
    fused block kernel launches in fp32 (they take bf16 only)."""
    bf16 = _step_launches(monkeypatch, "bfloat16")
    f32 = _step_launches(monkeypatch, "float32")
    to_f32 = {"sfm_flash_fwd_bf16": "sfm_flash_fwd_f32",
              "sfm_frame_ctx_fwd_bf16": "sfm_frame_ctx_fwd_f32",
              "sfm_flash_bwd_dq_sm90": "sfm_flash_bwd_dq_f32",
              "sfm_flash_bwd_dkv_sm90": "sfm_flash_bwd_dkv_f32"}
    assert f32 == [to_f32[n] for n in bf16 if n in to_f32]
    d, v = 2, 1
    assert {n: f32.count(n) for n in to_f32.values()} == {
        "sfm_flash_fwd_f32": v + 6 * d, "sfm_frame_ctx_fwd_f32": 2 * d,
        "sfm_flash_bwd_dq_f32": v + 4 * d, "sfm_flash_bwd_dkv_f32": v + 4 * d}


@pytest.mark.parametrize("variant", ["as shipped", "dk/dv q tiles of 32, two stages"])
def test_f32_d128_bwd_ablation_variants_patch_the_shipped_source(variant):
    """The backward variants of tools/ablate_attention.py's "f32" part find
    each text they patch once in the shipped source and change it unless
    they are the source."""
    from self_supervise_sfm_tpu_torch.tools import ablate_attention as ABL

    src = ABL.patched_sources(ABL.F32_BWD_SOURCE,
                              {variant: ABL.F32_D128_BWD_VARIANTS[variant]})[variant]
    assert (src == SOURCE) == (variant == "as shipped")
