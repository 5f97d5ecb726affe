"""The tile schedule of the Hopper attention body (K1, K1m, K2, K2p), emulated
on the CPU and held against the JAX Pallas kernels and the port's plain
versions.

``csrc/flash_fwd_sm90.cu`` runs only on the card. :func:`_emulate` repeats its
arithmetic tile by tile in PyTorch: 128-key tiles whose ragged tail is
zero-filled and whose logits past the source's end are forced to NEG_INF by
select; the running max in the log2 domain; p = exp2(s * c - m) with one
rounding of the argument (the kernel's FFMA), flushed to zero below 2^-126
(ex2.approx.ftz) and rounded to bf16 against the running max before PV;
O = O * alpha + P V a tile; out = O * (1 / l); for K2 the context tiles of
the frame's scene, then the frame's own tiles, in one softmax; for K1m
(the flash forward under a RelocMask) K2's order over the mask's segments:
a slice is one frame of one head, streaming the head's context tiles, then
the frame's own, each from its segment's key 0. It is held against the
Pallas kernels in interpret mode (as ``test_torch_attention.py`` runs them)
and against the port's plain versions with the tolerance phase 2 of
``chip_smoke.py`` applies on the card: 4 bf16 ulps at the largest output,
lse within 1e-4. K1m's walk (its producer's box coordinates, transcribed)
is checked pair by pair against the mask.
"""

import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.ops import flash_attention as JFA
from self_supervise_sfm_tpu.ops.mask_spec import RelocMask as JRelocMask
from self_supervise_sfm_tpu_torch import _kernels as TK
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA
from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

torch.set_num_threads(1)

CSRC = Path(TFA.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "flash_fwd_sm90.cu").read_text()
BM = 128  # q rows a work tile of the kernel
BK = 128  # keys a K / V tile of the kernel
SMS = 132
D = 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634
SCALE_LOG2 = np.float32(D**-0.5 * LOG2E)  # the kernel's fp32 scale


def _ulps(ref, n: int) -> float:
    """n bf16 ulps at the largest |ref|."""
    return n * 2.0 ** (math.floor(math.log2(float(np.abs(_np(ref)).max()))) - 7)


def _exp2_ftz(x: torch.Tensor) -> torch.Tensor:
    p = torch.exp2(x)
    return torch.where(p < 2.0**-126, torch.zeros_like(p), p)


def _emulate(q, sources, lse: bool = False):
    """The kernel's schedule over ``sources``, a list of (k, v) streamed in
    order into one online softmax. q: (S, Nq, d) bf16; k / v: (S, N, d) bf16,
    d = 64 or 128: S is summed over the rows' 64-channel swizzle atoms in
    order, as the k steps walk them. Returns out (S, Nq, d) bf16 and, if
    asked, the natural-log lse."""
    S, nq, d = q.shape
    qf = q.float()
    m = torch.full((S, nq), NEG_INF, dtype=torch.float32)
    l = torch.zeros((S, nq), dtype=torch.float32)
    o = torch.zeros((S, nq, d), dtype=torch.float32)
    c = torch.tensor(np.float32(d**-0.5 * LOG2E), dtype=torch.float32)  # the kernel's fp32 scale
    for k, v in sources:
        n = k.shape[1]
        for k0 in range(0, n, BK):
            valid = min(BK, n - k0)
            kt = torch.zeros((S, BK, d), dtype=k.dtype)  # the TMA box's zero fill
            vt = torch.zeros((S, BK, d), dtype=v.dtype)
            kt[:, :valid] = k[:, k0:k0 + valid]
            vt[:, :valid] = v[:, k0:k0 + valid]
            s = sum(torch.matmul(qf[..., a:a + 64], kt[..., a:a + 64].float().transpose(-1, -2))
                    for a in range(0, d, 64))
            s[..., valid:] = NEG_INF
            m_new = torch.maximum(m, s.amax(-1) * c)
            alpha = _exp2_ftz(m - m_new)
            # s * c - m with one rounding, as the FFMA (exact product in fp64)
            arg = (s.double() * float(c) - m_new.double()[..., None]).float()
            p = _exp2_ftz(arg)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.matmul(p.to(v.dtype).float(), vt.float())
            m = m_new
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (o * (1.0 / l_safe)[..., None]).to(q.dtype)
    if lse:
        return out, m * (1.0 / LOG2E) + torch.log(l_safe)
    return out


def _bf16_pair(rng, shape):
    """The same bf16 values for JAX and for PyTorch."""
    a = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jnp.bfloat16)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.array(x.astype(jnp.float32))


def _assert_close(got, ref, tol, what):
    err = float(np.abs(_np(got) - _np(ref)).max())
    assert err <= tol, f"{what}: max abs error {err} over {tol}"


# -- K1 ------------------------------------------------------------------------

# (nq, nk, d): ragged tails; at head dim 128 both swizzle atoms of a row
K1_SHAPES = {"200x333": (200, 333, D), "130x70": (130, 70, D), "200x333_d128": (200, 333, 128)}


@pytest.fixture(scope="module")
def k1_cases():
    rng = np.random.default_rng(7)
    cases = {}
    for name, (nq, nk, d) in K1_SHAPES.items():
        (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, (1, 2, n, d)) for n in (nq, nk, nk))
        out, lse = _emulate(tq[0], [(tk[0], tv[0])], lse=True)
        j_out, j_lse = JFA.flash_attention_lse(jq, jk, jv, bq=128, bk=BK, interpret=True)
        p_out, p_lse = TFA.flash_fwd_plain(tq[0], tk[0], tv[0])
        cases[name] = dict(emu=(out, lse), pallas=(j_out[0], j_lse[0]), plain=(p_out, p_lse))
    return cases


@pytest.mark.parametrize("ref", ["pallas", "plain"])
@pytest.mark.parametrize("shape", list(K1_SHAPES))
def test_k1_schedule_matches(k1_cases, shape, ref):
    out, lse = k1_cases[shape]["emu"]
    r_out, r_lse = k1_cases[shape][ref]
    _assert_close(out, r_out, _ulps(r_out, 4), f"K1 {shape} out vs {ref}")
    _assert_close(lse, r_lse, 1e-4, f"K1 {shape} lse vs {ref}")


# -- K2 and K2p ----------------------------------------------------------------

B, F, H, P, NC, DEPTH = 2, 2, 2, 130, 77, 3


def _bcast(c):
    """(B, H, Nc, d) -> (B*F, H, Nc, d): each frame sees its scene's context."""
    return c[:, None].expand(B, F, *c.shape[1:]).reshape(B * F, *c.shape[1:])


def _emulate_frame_ctx(q, k, v, ck, cv):
    """K2's order: the scene's context tiles, then the frame's own tiles.
    (B*F, H, P, d) frame-major slices."""
    flat = lambda x: x.reshape(-1, *x.shape[2:])  # noqa: E731
    out = _emulate(flat(q), [(flat(_bcast(ck)), flat(_bcast(cv))), (flat(k), flat(v))])
    return out.reshape(q.shape)


def _k2_case(d: int, seed: int):
    rng = np.random.default_rng(seed)
    D = d  # noqa: N806 - the head dim of this case
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, (B * F, H, P, D)) for _ in range(3))
    jkv, tkv = _bf16_pair(rng, (DEPTH, B, H, NC, 2 * D))
    layer = DEPTH - 1
    jck, jcv = jkv[layer, ..., :D], jkv[layer, ..., D:]
    tck, tcv = tkv[layer, ..., :D].contiguous(), tkv[layer, ..., D:].contiguous()
    return dict(
        torch=(tq, tk, tv, tck, tcv, tkv, layer),
        emu=_emulate_frame_ctx(tq, tk, tv, tck, tcv),
        # the context read as views of the cache's [k | v] rows, not copies
        emu_packed=_emulate_frame_ctx(tq, tk, tv, tkv[layer, ..., :D], tkv[layer, ..., D:]),
        pallas=JFA.frame_ctx_kernel(jq, jk, jv, jck, jcv, bq=128, bk=BK, interpret=True),
        pallas_packed=JFA.frame_ctx_packed_kernel(jq, jk, jv, jkv, layer, bq=128, bk=BK,
                                                  interpret=True),
        plain=TFA._frame_ctx_dense(tq, tk, tv, tck, tcv),
        plain_packed=TFA.frame_ctx_packed_plain(tq, tk, tv, tkv, layer),
    )


@pytest.fixture(scope="module")
def k2_case():
    return _k2_case(D, 11)


@pytest.fixture(scope="module")
def k2_case_d128():
    """K2 and K2p at head dim 128: a cache row of 2 x 128 channels, the v half
    128 channels on."""
    return _k2_case(128, 17)


@pytest.mark.parametrize("ref", ["pallas", "plain", "pallas_packed", "plain_packed"])
def test_k2_schedule_matches(k2_case, ref):
    r = k2_case[ref]
    emu = k2_case["emu_packed" if ref.endswith("packed") else "emu"]
    _assert_close(emu, r, _ulps(r, 4), f"K2 schedule vs {ref}")


@pytest.mark.parametrize("ref", ["pallas", "plain", "pallas_packed", "plain_packed"])
def test_k2_schedule_matches_d128(k2_case_d128, ref):
    """K2's and K2p's schedule at head dim 128 against the Pallas kernels in
    interpret mode and the plain versions; K2p bit-equal to K2 on the split
    copies."""
    c = k2_case_d128
    emu = c["emu_packed" if ref.endswith("packed") else "emu"]
    _assert_close(emu, c[ref], _ulps(c[ref], 4), f"K2 d128 schedule vs {ref}")
    assert torch.equal(c["emu_packed"], c["emu"])


def test_k2p_split_copy_identity(k2_case):
    """K2p reads the same values as K2 on the layer's split copies, through
    the same schedule: the two agree bit for bit (chip_smoke.py checks the
    kernels so), and so do the plain versions."""
    assert torch.equal(k2_case["emu_packed"], k2_case["emu"])
    assert torch.equal(k2_case["plain_packed"], k2_case["plain"])


def test_k2_context_tiles_restart_at_key_zero(k2_case):
    """Tile boundaries restart at key 0 of each source: the [ctx | own]
    concatenation streamed as one source puts other keys into each tile and
    moves the bf16 rounding of p, but stays within the tolerance."""
    tq, tk, tv, tck, tcv, _, _ = k2_case["torch"]
    flat = lambda x: x.reshape(-1, *x.shape[2:])  # noqa: E731
    one = _emulate(flat(tq), [(torch.cat([flat(_bcast(tck)), flat(tk)], 1),
                               torch.cat([flat(_bcast(tcv)), flat(tv)], 1))])
    two = k2_case["emu"]
    assert not torch.equal(one.reshape(two.shape), two)  # NC = 77 is not a tile multiple
    _assert_close(one.reshape(two.shape), two, _ulps(two, 4), "one source vs two")


# -- K1m: the flash forward under a RelocMask, K2's walk over segment maps -----

# (n_ctx, P, F): context and frame tails, no context, whole 128-row segments,
# frames shorter than a box, one frame
K1M_MASKS = {"77x130x2": (77, 130, 2), "0x130x3": (0, 130, 3), "128x128x2": (128, 128, 2),
             "5x7x3": (5, 7, 3), "77x130x1": (77, 130, 1)}
K1M_BH = 2
# the same at head dim 128: context and frame tails, frames shorter than a box
K1M_D128 = {"77x130x2_d128": (77, 130, 2), "5x7x3_d128": (5, 7, 3)}


def _emulate_reloc(q, k, v, mask):
    """K1m's schedule: q (BH, F*P, d) read as BH*F slices of P rows (slice =
    bh * F + f), each streaming the first n_ctx rows of k's slice bh, then
    frame f's P keys; out (BH, F*P, d) and the lse (BH, F*P)."""
    BH, _, d = q.shape
    n_ctx, P, F = mask.n_ctx, mask.frame_size, mask.num_frames
    slices = lambda x: x.reshape(BH * F, P, d)  # noqa: E731
    ctx = lambda x: x[:, :n_ctx].repeat_interleave(F, dim=0)  # noqa: E731
    out, lse = _emulate(slices(q), [(ctx(k), ctx(v)), (slices(k[:, n_ctx:]), slices(v[:, n_ctx:]))],
                        lse=True)
    return out.reshape(q.shape), lse.reshape(BH, F * P)


@pytest.fixture(scope="module")
def k1m_cases():
    rng = np.random.default_rng(13)
    cases = {}
    for name, (n_ctx, P, F) in {**K1M_MASKS, **K1M_D128}.items():
        d = 128 if name in K1M_D128 else D
        mask, jmask = RelocMask(n_ctx, P, F), JRelocMask(n_ctx, P, F)
        (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, (K1M_BH, n, d))
                                        for n in (mask.nq, mask.nk, mask.nk))
        j_out, j_lse = JFA._flash_fwd(jq, jk, jv, jmask, 128, BK, True)
        cases[name] = dict(torch=(tq, tk, tv, mask), emu=_emulate_reloc(tq, tk, tv, mask),
                           pallas=(j_out, j_lse),
                           plain=TFA.flash_fwd_plain(tq, tk, tv, mask))
    return cases


@pytest.mark.parametrize("ref", ["pallas", "plain"])
@pytest.mark.parametrize("case", list(K1M_MASKS) + list(K1M_D128))
def test_k1m_schedule_matches(k1m_cases, case, ref):
    out, lse = k1m_cases[case]["emu"]
    r_out, r_lse = k1m_cases[case][ref]
    _assert_close(out, r_out, _ulps(r_out, 4), f"K1m {case} out vs {ref}")
    _assert_close(lse, r_lse, 1e-4, f"K1m {case} lse vs {ref}")


@pytest.mark.parametrize("case", list(K1M_MASKS) + list(K1M_D128))
def test_k1m_is_k2_on_the_unfolded_tensors(k1m_cases, case):
    """The same problem in layout form: frame-major (F, H, P, d) q / k / v
    and the head's context as K2's (1, H, n_ctx, d). K2's schedule over them
    gives K1m's output bit for bit (the kernels are held to this on the
    card, K1m against K2p)."""
    tq, tk, tv, mask = k1m_cases[case]["torch"]
    n_ctx, P, F = mask.n_ctx, mask.frame_size, mask.num_frames
    d = tq.shape[-1]

    def fold(x):  # (H, F*P, d) -> (F*H, P, d), slice f * H + h
        return x.reshape(K1M_BH, F, P, d).transpose(0, 1).reshape(F * K1M_BH, P, d)

    def ctx(x):
        return x[:, :n_ctx].repeat(F, 1, 1)

    k2 = _emulate(fold(tq), [(ctx(tk), ctx(tv)), (fold(tk[:, n_ctx:]), fold(tv[:, n_ctx:]))])
    assert torch.equal(fold(k1m_cases[case]["emu"][0]), k2)


def _k1m_params(bh: int, mask: RelocMask) -> dict:
    """make_params of sfm_flash_fwd_reloc_sm90: BH * F slices of P q rows."""
    slices = bh * mask.num_frames
    q_tiles = -(-mask.frame_size // BM)
    return dict(slices=slices, nq=mask.frame_size, nk=mask.frame_size, nc=mask.n_ctx,
                frames=mask.num_frames, q_tiles=q_tiles, tiles=q_tiles * slices)


def _k1m_work(p: dict, tile: int):
    """The producer's coordinates for work tile ``tile``, transcribed, as
    global indices of the (BH, F*P, d) q and the (BH, n_ctx + F*P, d) k:
    (bh, q rows [r0, r1), the key ranges of its tiles in order). A box of
    the q map (slices of P rows) and of the own map ((64, P, F, BH)) clips at
    the frame's end, one of the context map ((64, n_ctx, 1, BH)) at n_ctx."""
    slice_ = tile // p["q_tiles"]
    q0 = (tile % p["q_tiles"]) * BM
    c3 = slice_ // p["frames"]  # the context map's coordinate 3: bh
    f = slice_ % p["frames"]
    P, nc = p["nq"], p["nc"]
    keys = [(i * BK, min(i * BK + BK, nc)) for i in range(-(-nc // BK))]
    own = nc + f * P
    keys += [(own + j * BK, own + min(j * BK + BK, P)) for j in range(-(-P // BK))]
    # stores: o + slice * P * 64, rows below P; the lse at slice * P + row
    return c3, f * P + q0, f * P + min(q0 + BM, P), keys


K1M_WALKS = {**{m: (K1M_BH, K1M_MASKS[m]) for m in K1M_MASKS},
             "reloc layer 0": (16, (610, 1374, 2)), "reloc 5 queries": (16, (1525, 1374, 5))}


@pytest.mark.parametrize("case", list(K1M_WALKS))
def test_k1m_walk_visits_each_allowed_pair_once(case):
    """Over K1m's work tiles: every allowed (q, k) pair of every head is
    visited once and no other pair is (the mask lives only in the maps);
    every q row is stored by one work tile; every work tile is taken by one
    block of the persistent grid."""
    bh, (n_ctx, P, F) = K1M_WALKS[case]
    mask = RelocMask(n_ctx, P, F)
    p = _k1m_params(bh, mask)
    grid = min(p["tiles"], SMS)
    taken = sorted(t for b in range(grid) for t in range(b, p["tiles"], grid))
    assert taken == list(range(p["tiles"]))
    visits = np.zeros((mask.nq, mask.nk), np.uint8)  # summed over the heads
    stored = np.zeros((bh, mask.nq), np.int32)
    for t in range(p["tiles"]):
        h, r0, r1, keys = _k1m_work(p, t)
        assert r1 - r0 <= BM
        stored[h, r0:r1] += 1
        for k0, k1 in keys:
            assert 0 < k1 - k0 <= BK
            visits[r0:r1, k0:k1] += 1
    assert (stored == 1).all()
    allowed = mask.materialize()[0, 0].numpy()
    assert (visits == bh * allowed.astype(np.uint8)).all()


def test_k1m_work_tiles_at_the_reloc_sites():
    """The counts the source quotes: 352 work tiles of 5 context and 11 own
    key tiles at reloc layer 0, 880 of 12 + 11 at 5 queries (K2p's work
    against the 5-anchor cache, tile for tile)."""
    for case, want in (("reloc layer 0", (352, 5, 11)), ("reloc 5 queries", (880, 12, 11))):
        bh, (n_ctx, P, F) = K1M_WALKS[case]
        p = _k1m_params(bh, RelocMask(n_ctx, P, F))
        kinds = {(sum(k0 < n_ctx for k0, _ in keys), sum(k0 >= n_ctx for k0, _ in keys))
                 for *_, keys in (_k1m_work(p, t) for t in range(p["tiles"]))}
        assert (p["tiles"], *kinds.pop()) == want and not kinds
    assert ("At reloc layer\n// 0, (16, 2748) x (16, 3358), that is 352 work tiles of 5 context "
            "and 11 own\n// key tiles; at 5 queries, (16, 6870) x (16, 8395), 880 of 12 + 11."
            ) in SOURCE


def test_k1m_source_is_k2s_body_over_segment_maps():
    """The producer's box coordinates and maps that :func:`_k1m_work`
    transcribes, the lse store under RELOC, the kernel's own name, and the
    first body gone: no mma.sync left under csrc/, the C entry replaced."""
    for line in (
            "if (RELOC) c3 = slice / p.frames;",
            "tma_load_4d(sk, mck, full, ch, i * BN, c2, c3);",
            "tma_load_4d(sk, mk, full, ch, (i - ctx_tiles) * BN, slice % p.frames, c3);",
            "tma_load_4d(sv, mv, full, ch, (i - ctx_tiles) * BN, slice % p.frames, c3);",
            "if ((!CTX || RELOC) && t == 0) {",
            "attention<D, true, true>(&mq, &mk, &mv, &mck, &mcv, p);",
            "!encode_rows<D>(&mq, q, frame_size, bh * num_frames) ||",
            "!encode_rows64(&mk, kb + own, 4, frame_size, D * 2, num_frames, bh, slice_bytes, BN, D) ||",
            "!encode_rows64(&mck, kb, 4, n_ctx, D * 2, 1, bh, slice_bytes, BN, D) ||",
            "static const void* ready[KERNELS] = {};",
            "const Kernel5 kernel = Kernels<D>::k1m;"):
        assert SOURCE.count(line) == 1, line
    assert "flash_fwd_reloc_sm90_kernel)" in SOURCE and "flash_fwd_reloc_d128_sm90_kernel)" in SOURCE
    assert not (CSRC / "flash_attention.cu").exists()
    for src in CSRC.iterdir():
        text = src.read_text()
        assert "mma.sync" not in text and "mma_16816" not in text, src.name
    assert "sfm_flash_fwd_reloc_sm90" in TK._SIGNATURES
    assert "sfm_flash_fwd_reloc_d128_sm90" in TK._SIGNATURES
    assert "sfm_flash_fwd_reloc_bf16" not in TK._SIGNATURES


def _sw128(addr: int) -> int:
    """The 128-byte swizzle of a shared-memory byte address: its 16-byte
    chunk index (bits 4-6) xor its row within the 1024-byte repeat (bits
    7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


@pytest.mark.parametrize("d", [64, 128])
def test_tiles_walk_both_swizzle_atoms(d):
    """The shared-memory image of a Q / K / V tile and the wgmma descriptors'
    walk over it, from the source's constants. TMA writes a row's channels
    in boxes of 64 (one 128-byte swizzle row), box a at a * rows * 128 bytes;
    S = Q K^T reads its k step kk at (kk / 4) atoms plus 32 (kk % 4) bytes
    (K-major, 8-row groups 1024 bytes apart), and PV reads V MN-major, 16
    keys (2048 bytes) a k step, the second 64 channels one leading byte
    offset (an atom) on. Every (row, channel) a product reads is where the
    box put it: at head dim 128 both atoms of a row, in order."""
    for line in ("constexpr int ATOM_ROW = 128;",
                 "static constexpr int ATOMS = D / 64;",
                 "tma_load_3d(base + a * L::Q_ATOM, mq, q_full, 64 * a, q0, slice);",
                 "desc_add(desc_q, (kk / 4) * (L::Q_ATOM >> 4) + 2 * (kk % 4))",
                 "desc_add(desc_k, (kk / 4) * (L::KV_ATOM >> 4) + 2 * (kk % 4)), kk);",
                 "const uint64_t desc_v = sw128_desc(base + V_OFF + st * KV_BYTES, L::KV_ATOM >> 4);",
                 "wgmma_rs_m64n128(o, pa[kk], desc_add(desc_v, 128 * kk));",
                 "return encode_rows64(map, ptr, 3, static_cast<uint64_t>(n), D * 2,",
                 "!encode_rows64(&mcv, ckv_k + D, 4, nc, 4 * D, bh, layer + 1, layer_bytes, BN, D))"):
        assert line in SOURCE, line
    rows, atom = BM, BM * 128  # a 128-row tile: 16 KB an atom

    def tma(r, ch):  # where the box of channel ch / 64 put (row r, channel ch)
        return _sw128((ch // 64) * atom + r * 128 + 2 * (ch % 64))

    for kk in range(d // 16):  # S: the k step's 16 channels of every row
        start = (kk // 4) * atom + 32 * (kk % 4)
        for r in range(rows):
            for j in range(16):
                got = _sw128(start + (r // 8) * 1024 + (r % 8) * 128 + 2 * j)
                assert got == tma(r, 16 * kk + j)
    for kk in range(BK // 16):  # PV: 16 keys of V, every channel
        start = 2048 * kk
        for j in range(16):
            for ch in range(d):
                lead = (ch // 64) * atom  # the descriptor's leading byte offset
                got = _sw128(start + lead + (j // 8) * 1024 + (j % 8) * 128 + 2 * (ch % 64))
                assert got == tma(16 * kk + j, ch)
    # a cache row is [k | v], 2 d channels: the v half's map starts d channels on
    assert 4 * d == 2 * (2 * d) and (2 * d * 2) % 16 == 0
