"""The tile schedule of the fp32 attention body (the fp32 forms of K1, K2 and
K2p), emulated on the CPU and held against the JAX Pallas kernels in fp32
and the port's plain versions; the routing rule of fp32 sites under remat.

``csrc/flash_fwd_f32.cu`` runs only on the card. :func:`_emulate` repeats
its arithmetic tile by tile in PyTorch, at head dim 64 or 128 (the tiles of
each read from the source): 64-key tiles whose ragged tail is zero-filled and whose logits past the source's end are
forced to NEG_INF by select; fp32 logits; the running max in the log2
domain; p = exp2(s * c - m) with one rounding of the argument (the kernel's
FFMA), flushed to zero below 2^-126 (ex2.approx.ftz) and kept in fp32 for
PV; O = O * alpha + P V a tile; out = O / l; for K2 and K2p the context
tiles of the frame's scene, then the frame's own tiles, in one softmax. It
is held against the Pallas kernels in interpret mode (as
``test_torch_attention.py`` runs them) and the plain versions with the
tolerance phase 2 of ``chip_smoke.py`` applies to the fp32 entries on the
card: 2e-5 at the largest |out| (``test_torch_attention.py``'s fp32
tolerance against JAX), lse within 1e-5. The cases named "d128-..." run
the same at head dim 128.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.ops import flash_attention as JFA
from self_supervise_sfm_tpu_torch import _kernels as TK
from self_supervise_sfm_tpu_torch.layers import block as TB
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA

torch.set_num_threads(1)

SOURCE = (Path(TFA.__file__).resolve().parents[1] / "csrc" / "flash_fwd_f32.cu").read_text()
BK = int(re.search(r"constexpr int BN = (\d+);", SOURCE).group(1))  # keys a K / V tile
# keys a K / V tile by head dim
TILES = {64: BK, 128: int(re.search(r"constexpr int BN_D128 = (\d+);", SOURCE).group(1))}
D = 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634
TOL, LSE_TOL = 2e-5, 1e-5


def _scale_log2(d: int):
    """The kernel's fp32 scale * log2(e) at head dim ``d``."""
    return np.float32(d**-0.5 * LOG2E)


def _exp2_ftz(x: torch.Tensor) -> torch.Tensor:
    p = torch.exp2(x)
    return torch.where(p < 2.0**-126, torch.zeros_like(p), p)


def _emulate(q, sources, lse: bool = False):
    """The kernel's schedule over ``sources``, a list of (k, v) streamed in
    order into one online softmax, with the tiles of q's head dim. q: (S,
    Nq, d) fp32; k / v: (S, N, d) fp32. Returns out (S, Nq, d) fp32 and, if
    asked, the natural-log lse."""
    S, nq, d = q.shape
    bk = TILES[d]
    m = torch.full((S, nq), NEG_INF, dtype=torch.float32)
    l = torch.zeros((S, nq), dtype=torch.float32)
    o = torch.zeros((S, nq, d), dtype=torch.float32)
    c = torch.tensor(_scale_log2(d), dtype=torch.float32)
    for k, v in sources:
        n = k.shape[1]
        for k0 in range(0, n, bk):
            valid = min(bk, n - k0)
            kt = torch.zeros((S, bk, d), dtype=torch.float32)  # the zero-filled copy
            vt = torch.zeros((S, bk, d), dtype=torch.float32)
            kt[:, :valid] = k[:, k0:k0 + valid]
            vt[:, :valid] = v[:, k0:k0 + valid]
            s = torch.matmul(q, kt.transpose(-1, -2))
            s[..., valid:] = NEG_INF
            m_new = torch.maximum(m, s.amax(-1) * c)
            alpha = _exp2_ftz(m - m_new)
            # s * c - m with one rounding, as the FFMA (exact product in fp64)
            p = _exp2_ftz((s.double() * float(c) - m_new.double()[..., None]).float())
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.matmul(p, vt)  # p stays fp32
            m = m_new
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = o / l_safe[..., None]
    if lse:
        return out, m * (1.0 / LOG2E) + torch.log(l_safe)
    return out


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


# -- K1 ------------------------------------------------------------------------

# (q rows, keys, head dim): ragged q and key tails, one q row against a key
# past a tile, whole tiles; at head dim 128 the ragged tails and one row
K1_SHAPES = {"200x333": (200, 333, 64), "130x70": (130, 70, 64), "1x65": (1, 65, 64),
             "128x64": (128, 64, 64), "d128-200x333": (200, 333, 128),
             "d128-1x65": (1, 65, 128)}


@pytest.fixture(scope="module")
def k1_cases():
    rng = np.random.default_rng(17)
    cases = {}
    for name, (nq, nk, d) in K1_SHAPES.items():
        (jq, tq), (jk, tk), (jv, tv) = (_f32_pair(rng, (1, 2, n, d)) for n in (nq, nk, nk))
        j_out, j_lse = JFA.flash_attention_lse(jq, jk, jv, bq=128, bk=TILES[d], interpret=True)
        cases[name] = dict(emu=_emulate(tq[0], [(tk[0], tv[0])], lse=True),
                           pallas=(j_out[0], j_lse[0]),
                           plain=TFA.flash_fwd_plain(tq[0], tk[0], tv[0]))
    return cases


@pytest.mark.parametrize("ref", ["pallas", "plain"])
@pytest.mark.parametrize("shape", list(K1_SHAPES))
def test_k1_f32_schedule_matches(k1_cases, shape, ref):
    out, lse = k1_cases[shape]["emu"]
    r_out, r_lse = k1_cases[shape][ref]
    _assert_close(out, r_out, f"K1 fp32 {shape} out vs {ref}")
    _assert_close(lse, r_lse, f"K1 fp32 {shape} lse vs {ref}", lse=True)


def test_k1_f32_wrapper_on_cpu_is_the_plain_version(k1_cases):
    """On a CPU tensor the fp32 wrapper runs its plain version and counts no
    launch, bf16 or fp32."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, n, D)).astype(np.float32))
               for n in (70, 90, 90))
    n0 = (TFA.flash_fwd.launches, TFA.flash_fwd.launches_f32)
    out, lse = TFA.flash_fwd(q, k, v)
    p_out, p_lse = TFA.flash_fwd_plain(q, k, v)
    assert torch.equal(out, p_out) and torch.equal(lse, p_lse) and out.dtype == torch.float32
    assert (TFA.flash_fwd.launches, TFA.flash_fwd.launches_f32) == n0


# -- K2 and K2p ----------------------------------------------------------------

# (B, F, H, P, Nc, head dim): context and frame tails over two scenes; a
# context of one key, three frames of a scene; the tails at head dim 128
K2_SHAPES = {"2x2x2x130x77": (2, 2, 2, 130, 77, 64), "1x3x2x70x1": (1, 3, 2, 70, 1, 64),
             "d128-2x2x1x130x77": (2, 2, 1, 130, 77, 128)}
DEPTH = 3


def _bcast(c, F):
    """(B, H, Nc, d) -> (B*F, H, Nc, d): each frame sees its scene's context."""
    B = c.shape[0]
    return c[:, None].expand(B, F, *c.shape[1:]).reshape(B * F, *c.shape[1:])


def _emulate_frame_ctx(q, k, v, ck, cv):
    """K2's order: the scene's context tiles, then the frame's own tiles.
    (B*F, H, P, d) frame-major slices."""
    F = q.shape[0] // ck.shape[0]
    flat = lambda x: x.reshape(-1, *x.shape[2:])  # noqa: E731
    out = _emulate(flat(q), [(flat(_bcast(ck, F)), flat(_bcast(cv, F))), (flat(k), flat(v))])
    return out.reshape(q.shape)


@pytest.fixture(scope="module")
def k2_cases():
    rng = np.random.default_rng(19)
    cases = {}
    for name, (B, F, H, P, NC, d) in K2_SHAPES.items():
        (jq, tq), (jk, tk), (jv, tv) = (_f32_pair(rng, (B * F, H, P, d)) for _ in range(3))
        jkv, tkv = _f32_pair(rng, (DEPTH, B, H, NC, 2 * d))
        bk = TILES[d]
        for layer in (0, DEPTH - 1):
            jck, jcv = jkv[layer, ..., :d], jkv[layer, ..., d:]
            tck, tcv = tkv[layer, ..., :d].contiguous(), tkv[layer, ..., d:].contiguous()
            cases[name, layer] = dict(
                emu=_emulate_frame_ctx(tq, tk, tv, tck, tcv),
                # the context read as views of the cache's [k | v] rows
                emu_packed=_emulate_frame_ctx(tq, tk, tv, tkv[layer, ..., :d],
                                              tkv[layer, ..., d:]),
                pallas=JFA.frame_ctx_kernel(jq, jk, jv, jck, jcv, bq=128, bk=bk,
                                            interpret=True),
                pallas_packed=JFA.frame_ctx_packed_kernel(jq, jk, jv, jkv, layer, bq=128,
                                                          bk=bk, interpret=True),
                plain=TFA._frame_ctx_dense(tq, tk, tv, tck, tcv),
                plain_packed=TFA.frame_ctx_packed_plain(tq, tk, tv, tkv, layer),
            )
    return cases


K2_CASES = [(name, layer) for name in K2_SHAPES for layer in (0, DEPTH - 1)]


@pytest.mark.parametrize("ref", ["pallas", "plain", "pallas_packed", "plain_packed"])
@pytest.mark.parametrize("case", K2_CASES, ids=[f"{n}-layer{li}" for n, li in K2_CASES])
def test_k2_f32_schedule_matches(k2_cases, case, ref):
    r = k2_cases[case][ref]
    emu = k2_cases[case]["emu_packed" if ref.endswith("packed") else "emu"]
    _assert_close(emu, r, f"K2 fp32 {case} schedule vs {ref}")


@pytest.mark.parametrize("case", K2_CASES, ids=[f"{n}-layer{li}" for n, li in K2_CASES])
def test_k2p_f32_reads_the_values_of_k2(k2_cases, case):
    """K2p reads the same values as K2 on the layer's split copies, through
    the same schedule: the two agree bit for bit (phase 2 of chip_smoke.py
    holds the kernels so), and so do the plain versions."""
    assert torch.equal(k2_cases[case]["emu_packed"], k2_cases[case]["emu"])
    assert torch.equal(k2_cases[case]["plain_packed"], k2_cases[case]["plain"])


# -- the source, the library's signatures, the route under remat ---------------


def test_f32_source_entries_and_constants():
    """The fp32 entries at head dims 64 and 128 (and the info entry) are
    defined in the source with the bf16 entries' arguments and registered
    in ``_SIGNATURES``; the body's tile constants are what the emulation
    reads, and its shared memory at each head dim is what the design says;
    FFMA, no tensor-core product, and the note names the TPU kernels it
    replaces."""
    for name, bf16 in (("sfm_flash_fwd_f32", "sfm_flash_fwd_bf16"),
                       ("sfm_frame_ctx_fwd_f32", "sfm_frame_ctx_fwd_bf16"),
                       ("sfm_frame_ctx_kv2_fwd_f32", "sfm_frame_ctx_kv2_fwd_bf16"),
                       ("sfm_flash_fwd_d128_f32", "sfm_flash_fwd_d128_bf16"),
                       ("sfm_frame_ctx_fwd_d128_f32", "sfm_frame_ctx_fwd_d128_bf16"),
                       ("sfm_frame_ctx_kv2_fwd_d128_f32", "sfm_frame_ctx_kv2_fwd_d128_bf16"),
                       ("sfm_flash_fwd_reloc_d128_f32", "sfm_flash_fwd_reloc_d128_sm90")):
        assert SOURCE.count(f'extern "C" int {name}(') == 1, name
        assert TK._SIGNATURES[name] == TK._SIGNATURES[bf16], name
    assert SOURCE.count('extern "C" int sfm_flash_fwd_f32_info(') == 1
    assert "sfm_flash_fwd_f32_info" in TK._SIGNATURES
    # q, two stages of K and V, P: two blocks an SM at 64, one at 128
    for d, smem in ((64, 104_448), (128, 186_368)):
        ld, kn = d + 4, TILES[d]
        assert (64 * ld + 4 * kn * ld + 64 * (kn + 4)) * 4 == smem
    assert "static constexpr int SMEM_BYTES = (BM * LD + 4 * KN * LD + BM * LDP) * 4;" in SOURCE
    for line in ("constexpr int BM = 64;", "constexpr int BN = 64;",
                 "constexpr int BN_D128 = 64;",
                 "s[i][j] = exp2_ftz(fmaf(s[i][j], p.scale_log2, -mn));",
                 "make_float4(og[0] / d, og[1] / d, og[2] / d, og[3] / d);",
                 "if (p.lse && tc == 0) p.lse[row] = m[i] * (1.0f / LOG2E) + logf(d);",
                 "if (k0 + tc + 16 * j >= nvalid) s[i][j] = NEG_INF;"):
        assert SOURCE.count(line) == 1, line
    assert "wgmma." not in SOURCE and "mma.sync" not in SOURCE
    for kernel in ("_flash_fwd", "frame_ctx_kernel", "frame_ctx_packed_kernel"):
        assert kernel in SOURCE


@pytest.mark.parametrize("variant", ["as shipped", "32-key tiles"])
def test_f32_d128_ablation_variants_patch_the_shipped_source(variant):
    """The forward variants of tools/ablate_attention.py's "f32" part find
    each text they patch once in the shipped source and change it unless
    they are the source; 32-key tiles at 128 fit two blocks an SM."""
    from self_supervise_sfm_tpu_torch.tools import ablate_attention as ABL

    src = ABL.patched_sources(ABL.F32_SOURCE, {variant: ABL.F32_D128_VARIANTS[variant]})[variant]
    assert (src == SOURCE) == (variant == "as shipped")
    kn = int(re.search(r"constexpr int BN_D128 = (\d+);", src).group(1))
    smem = (64 * 132 + 4 * kn * 132 + 64 * (kn + 4)) * 4
    assert smem == {64: 186_368, 32: 110_592}[kn]
    assert (2 * (smem + 1024) <= 233_472) == (kn == 32)  # two blocks an SM


def _walk(tree, fn):
    for v in tree.values():
        _walk(v, fn) if isinstance(v, dict) else fn(v)


@pytest.mark.parametrize("grad", [True, False])
def test_fp32_route_is_the_same_in_the_first_pass_and_the_recompute(monkeypatch, grad):
    """A frame block in fp32 on the card (meta tensors, ``_kernels.launch``
    recorded) under ``remat_call``: with grad, the first pass and the
    non-reentrant recompute both take K1's fp32 entry, and the backward
    B9's fp32 pair; without grad, one pass, K1's fp32 entry."""
    seen, routes = [], []
    monkeypatch.setattr(TK, "launch", lambda name, *args: seen.append(name))
    monkeypatch.setattr(TK, "stream_ptr", lambda t: 0)
    takes = TFA.kernel_takes

    def recorded(*args, **kw):
        routes.append(takes(*args, **kw))
        return routes[-1]

    monkeypatch.setattr(TFA, "kernel_takes", recorded)
    cfg = TB.BlockConfig(dim=256, num_heads=4, qk_norm=True)
    p = TB.init_block(None, "meta", cfg)
    n = 1374  # a 518 px frame's tokens: the gate's 1.5M cut
    x = torch.empty((2, n, 256), device="meta")
    rope = tuple(torch.empty((n, D), device="meta") for _ in range(2))
    with torch.set_grad_enabled(grad):
        if grad:
            _walk(p, lambda t: t.requires_grad_(True))
            x.requires_grad_(True)
        y = TB.remat_call(True, lambda x: TB.block(p, x, cfg, rope), x)
        if grad:
            y.sum().backward()
    assert routes == ([True, True] if grad else [True])
    assert seen == (["sfm_flash_fwd_f32"] * 2 + ["sfm_flash_bwd_dq_f32", "sfm_flash_bwd_dkv_f32"]
                    if grad else ["sfm_flash_fwd_f32"])
    assert y.dtype == torch.float32 and y.shape == x.shape
