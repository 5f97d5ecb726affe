"""The tile schedule of the Hopper attention body (K1, K2, K2p), emulated on
the CPU and held against the JAX Pallas kernels and the port's plain versions.

``csrc/flash_fwd_sm90.cu`` runs only on the card. :func:`_emulate` repeats its
arithmetic tile by tile in PyTorch: 128-key tiles whose ragged tail is
zero-filled and whose logits past the source's end are forced to NEG_INF by
select; the running max in the log2 domain; p = exp2(s * c - m) with one
rounding of the argument (the kernel's FFMA), flushed to zero below 2^-126
(ex2.approx.ftz) and rounded to bf16 against the running max before PV;
O = O * alpha + P V a tile; out = O * (1 / l); for K2 the context tiles of
the frame's scene, then the frame's own tiles, in one softmax. It is held
against the Pallas kernels in interpret mode (as ``test_torch_attention.py``
runs them) and against the port's plain versions with the tolerance phase 2
of ``chip_smoke.py`` applies on the card: 4 bf16 ulps at the largest output,
lse within 1e-4.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.ops import flash_attention as JFA
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA

torch.set_num_threads(1)

BK = 128  # keys a K / V tile of the kernel
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
    order into one online softmax. q: (S, Nq, d) bf16; k / v: (S, N, d) bf16.
    Returns out (S, Nq, d) bf16 and, if asked, the natural-log lse."""
    S, nq, d = q.shape
    qf = q.float()
    m = torch.full((S, nq), NEG_INF, dtype=torch.float32)
    l = torch.zeros((S, nq), dtype=torch.float32)
    o = torch.zeros((S, nq, d), dtype=torch.float32)
    c = torch.tensor(SCALE_LOG2, dtype=torch.float32)
    for k, v in sources:
        n = k.shape[1]
        for k0 in range(0, n, BK):
            valid = min(BK, n - k0)
            kt = torch.zeros((S, BK, d), dtype=k.dtype)  # the TMA box's zero fill
            vt = torch.zeros((S, BK, d), dtype=v.dtype)
            kt[:, :valid] = k[:, k0:k0 + valid]
            vt[:, :valid] = v[:, k0:k0 + valid]
            s = torch.matmul(qf, kt.float().transpose(-1, -2))
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

K1_SHAPES = {"200x333": (200, 333), "130x70": (130, 70)}


@pytest.fixture(scope="module")
def k1_cases():
    rng = np.random.default_rng(7)
    cases = {}
    for name, (nq, nk) in K1_SHAPES.items():
        (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, (1, 2, n, D)) for n in (nq, nk, nk))
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


@pytest.fixture(scope="module")
def k2_case():
    rng = np.random.default_rng(11)
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


@pytest.mark.parametrize("ref", ["pallas", "plain", "pallas_packed", "plain_packed"])
def test_k2_schedule_matches(k2_case, ref):
    r = k2_case[ref]
    emu = k2_case["emu_packed" if ref.endswith("packed") else "emu"]
    _assert_close(emu, r, _ulps(r, 4), f"K2 schedule vs {ref}")


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
