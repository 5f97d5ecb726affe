"""PyTorch port: ring attention over gloo ranks vs the JAX package's ring.

One launch of four gloo ranks on the CPU (``tests/_torch_dist_worker.py``)
runs ``ring_sdpa`` at context extents 2 and 4 (and 2 x 2 with the batch over
``data``), ``sdpa(impl="ring")`` and the applicability gate; the references
are JAX's ``ring_sdpa`` under ``make_mesh`` of the same extents on the
virtual CPU devices and JAX's dense attention. ``flash_attention_lse`` (its
lse output and cotangent) and the in-process fold need no process group.
fp32 throughout, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.ops import flash_attention as JFA
from self_supervise_sfm_tpu.ops import ring_attention as JRA
from self_supervise_sfm_tpu.ops.attention_core import sdpa_dense as j_dense
from self_supervise_sfm_tpu.parallel import sharding as JSh
from self_supervise_sfm_tpu_torch.ops import attention_core as TAC
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA
from self_supervise_sfm_tpu_torch.ops import ring_attention as TRA
from tests._torch_dist_worker import launch, load_tree, save_tree

torch.set_num_threads(1)

ATOL = 1e-5
WORLD = 4
# name -> (data, context) extents and the (B, H, N, d) of q, k, v
RING_CASES = {"n2": ((1, 2), (1, 2, 48, 16)), "n4": ((1, 4), (1, 2, 48, 16)),
              "d2_n2": ((2, 2), (2, 2, 48, 16))}
GATE_CASES = {"c4": ((1, 4), [(1, 2, 64, 8), (1, 2, 66, 8)]),
              "d4": ((4, 1), [(1, 2, 64, 8)]),
              "d2_c2": ((2, 2), [(1, 2, 64, 8), (1, 2, 66, 8)])}


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _loss(fn):
    return lambda q, k, v: jnp.sum(jnp.sin(fn(q, k, v)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results and the JAX references, from one launch."""
    tmp = tmp_path_factory.mktemp("ring")
    cases, refs = [], {}
    for i, (name, ((nd, nc), shape)) in enumerate(RING_CASES.items()):
        q, k, v = _qkv(i, shape)
        save_tree(tmp / f"{name}.in.npz", dict(q=q, k=k, v=v))
        cases.append(dict(name=name, kind="ring", mesh=[nd, nc, 1]))
        mesh = JSh.make_mesh(num_data=nd, num_context=nc)
        with JSh.activate_mesh(mesh):
            ring = jax.jit(lambda *a, m=mesh: JRA.ring_sdpa(*a, m))
            out = ring(q, k, v)
            grads = jax.jit(jax.grad(_loss(lambda *a, m=mesh: JRA.ring_sdpa(*a, m)),
                                     argnums=(0, 1, 2)))(q, k, v)
        dense = j_dense(*(jnp.asarray(t) for t in (q, k, v)))
        dense_grads = jax.grad(_loss(j_dense), argnums=(0, 1, 2))(q, k, v)
        odd = j_dense(*(jnp.asarray(t[:, :, 1:]) for t in (q, k, v)))
        refs[name] = dict(
            ring=dict(out=out, dq=grads[0], dk=grads[1], dv=grads[2]),
            dense=dict(out=dense, dq=dense_grads[0], dk=dense_grads[1], dv=dense_grads[2]),
            odd=odd)
    for name, ((nd, nc), shapes) in GATE_CASES.items():
        save_tree(tmp / f"gate_{name}.in.npz", dict(unused=np.zeros(1)))
        cases.append(dict(name=f"gate_{name}", kind="gate", mesh=[nd, nc, 1],
                          shapes=[list(s) for s in shapes]))
        mesh = JSh.make_mesh(num_data=nd, num_context=nc)
        want = [JRA.ring_applicable(jnp.zeros(s), mesh, None) for s in shapes]
        want += [JRA.ring_applicable(jnp.zeros(shapes[0]), None, None),
                 JRA.ring_applicable(jnp.zeros(shapes[0]), mesh, object())]
        refs[f"gate_{name}"] = np.array(want)
    launch(dict(cases=cases), WORLD, tmp)
    got = {}
    for case in cases:
        n = case["mesh"][0] * case["mesh"][1]
        got[case["name"]] = [load_tree(tmp / f"{case['name']}.r{r}.npz") for r in range(n)]
    return got, refs


@pytest.mark.parametrize("name", sorted(RING_CASES))
@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
def test_ring_matches_jax_ring_and_dense(ranks, name, what):
    got, refs = ranks
    for r, res in enumerate(got[name]):
        for ref in ("ring", "dense"):
            np.testing.assert_allclose(res[what].numpy(), np.asarray(refs[name][ref][what]),
                                       atol=ATOL, err_msg=f"rank {r} vs JAX {ref}")


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_sdpa_ring_dispatch(ranks, name):
    """``sdpa(impl="ring")`` takes the ring where it applies and "auto"
    where the token axis does not divide."""
    got, refs = ranks
    for res in got[name]:
        np.testing.assert_allclose(res["via_sdpa"].numpy(),
                                   np.asarray(refs[name]["dense"]["out"]), atol=ATOL)
        np.testing.assert_allclose(res["fallback"].numpy(), np.asarray(refs[name]["odd"]),
                                   atol=ATOL)


@pytest.mark.parametrize("name", sorted(GATE_CASES))
def test_applicability_gate_matches_jax(ranks, name):
    got, refs = ranks
    for res in got[f"gate_{name}"]:
        np.testing.assert_array_equal(res["applicable"].numpy().astype(bool),
                                      refs[f"gate_{name}"])


# -- no process group -------------------------------------------------------------


def test_merge_lives_in_ring_attention():
    assert TAC._merge is TRA._merge


def test_flash_lse_forward_matches_jax():
    q, k, v = _qkv(7, (1, 2, 48, 16))
    jo, jl = JFA.flash_attention_lse(q, k, v, interpret=True)
    to, tl = TFA.flash_attention_lse(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_flash_lse_cotangent_matches_jax():
    """The lse output carries a real cotangent (B9's ``dlse``): what makes
    the ring's merge differentiable when each chunk is K1."""
    q, k, v = _qkv(8, (1, 2, 32, 16))

    def j_loss(q, k, v):
        out, lse = JFA.flash_attention_lse(q, k, v, interpret=True)
        return jnp.sum(jnp.sin(out)) + jnp.sum(jnp.cos(lse))

    jg = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    out, lse = TFA.flash_attention_lse(tq, tk, tv)
    (torch.sin(out).sum() + torch.cos(lse).sum()).backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("use_flash", [True, False])
def test_fold_matches_jax_ring(n, use_flash):
    """The n-chunk fold in one process (K1 and B9's plain versions with
    ``use_flash``, the dense chunk without) against JAX's ring of n devices:
    forward and gradients."""
    q, k, v = _qkv(9, (1, 2, 48, 16))
    mesh = JSh.make_mesh(num_data=1, num_context=n)
    with JSh.activate_mesh(mesh):
        ring = lambda *a: JRA.ring_sdpa(*a, mesh)  # noqa: E731
        jout = jax.jit(ring)(q, k, v)
        jg = jax.jit(jax.grad(_loss(ring), argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    out = TRA.ring_fold(tq, tk, tv, n, use_flash=use_flash)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL)
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_fold_refuses_a_non_dividing_count():
    q, k, v = (torch.from_numpy(t) for t in _qkv(10, (1, 2, 48, 16)))
    with pytest.raises(ValueError):
        TRA.ring_fold(q, k, v, 5)
