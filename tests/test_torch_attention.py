"""PyTorch port: flash (K1) and frame-context (K2) attention vs the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold those plain versions against the Pallas kernels in interpret mode and
the JAX dense references, on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.ops import attention_core as JAC
from self_supervise_sfm_tpu.ops import flash_attention as JFA
from self_supervise_sfm_tpu_torch.ops import attention_core as TAC
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA
from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}
# fp32: summation order only. bf16: the inputs are the same bf16 values on
# both sides; outputs are bf16 (one rounding of ~4e-3 relative at |o| < 1),
# and p rounds to bf16 before PV on both sides.
TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}


def _qkv(rng, shape_q, shape_k, dtype):
    npd, jd, td = DTYPES[dtype]
    arrs = [rng.normal(size=s).astype(npd) for s in (shape_q, shape_k, shape_k)]
    # round once through the working dtype so both sides see identical values
    jx = [jnp.asarray(a).astype(jd) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(td) for a in jx]
    return jx, tx


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", [(128, 128), (200, 333), (130, 70)])
def test_flash_plain_matches_pallas_and_dense(rng, dtype, nq, nk):
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, (1, 2, nq, 64), (1, 2, nk, 64), dtype)
    # multi-tile online softmax in the Pallas kernel (bq = bk = 128)
    j_out, j_lse = JFA.flash_attention_lse(jq, jk, jv, bq=128, bk=128, interpret=True)
    j_dense = JAC.sdpa_dense(jq, jk, jv)
    t_out, t_lse = TFA.flash_attention_lse(tq, tk, tv)
    tol = TOL[dtype]
    assert t_out.dtype == tq.dtype and t_lse.dtype == torch.float32
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=tol)
    np.testing.assert_allclose(_np(t_out), _np(j_dense), atol=tol)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=1e-4, rtol=1e-5)


def test_flash_wrapper_on_cpu_is_the_plain_version(rng):
    (_, _, _), (tq, tk, tv) = _qkv(rng, (6, 200, 64), (6, 333, 64), "bfloat16")
    before = TFA.flash_fwd.launches
    out, lse = TFA.flash_fwd(tq, tk, tv)
    p_out, p_lse = TFA.flash_fwd_plain(tq, tk, tv)
    assert torch.equal(out, p_out) and torch.equal(lse, p_lse)
    assert TFA.flash_fwd.launches == before  # launches count kernel runs only


def test_flash_rejects_reloc_mask(rng):
    (_, _, _), (tq, tk, tv) = _qkv(rng, (1, 2, 8, 64), (1, 2, 8, 64), "float32")
    # anything but a RelocMask spec is refused; a RelocMask that does not
    # describe the logits is refused too (the masked kernel itself is held
    # against the JAX package in test_torch_packed_attention.py)
    with pytest.raises(TypeError):
        TFA.flash_attention(tq, tk, tv, mask=object())
    with pytest.raises(ValueError):
        TFA.flash_attention(tq, tk, tv, mask=RelocMask(4, 2, 3))


@pytest.mark.parametrize("impl", ["dense", "auto", "flash"])
def test_sdpa_dispatch_matches_jax(rng, impl):
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, (2, 3, 40, 16), (2, 3, 56, 16), "float32")
    mask = rng.uniform(size=(2, 1, 40, 56)) < 0.7
    mask[..., 0] = True
    for m_np in (None, mask):
        jm = None if m_np is None else jnp.asarray(m_np)
        tm = None if m_np is None else torch.from_numpy(m_np)
        ref = JAC.sdpa(jq, jk, jv, jm, impl="dense")
        out = TAC.sdpa(tq, tk, tv, tm, impl=impl)
        np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5)


def test_worth_it_gate():
    q = torch.empty(1, 1, 1374, 1)
    assert TFA.worth_it(q, torch.empty(1, 1, 1374, 1), None)
    assert not TFA.worth_it(q, torch.empty(1, 1, 1000, 1), None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,F,P,nc", [(1, 3, 96, 160), (2, 2, 130, 77)])
def test_frame_ctx_plain_matches_pallas_and_dense(rng, dtype, B, F, P, nc):
    H, d = 2, 64
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, (B * F, H, P, d), (B * F, H, P, d), dtype)
    (jck, jcv, _), (tck, tcv, _) = _qkv(rng, (B, H, nc, d), (B, H, nc, d), dtype)
    j_kernel = JFA.frame_ctx_kernel(jq, jk, jv, jck, jcv, bq=64, bk=64, interpret=True)
    j_dense = JFA._frame_ctx_dense(jq, jk, jv, jck, jcv)
    t_out = TFA.frame_ctx_attention(tq, tk, tv, tck, tcv)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(t_out), _np(j_dense), atol=tol)
    np.testing.assert_allclose(_np(t_out), _np(j_kernel), atol=tol)
