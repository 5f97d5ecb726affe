"""PyTorch port: Megatron's tensor-parallel blocks over gloo ranks vs the JAX
package's.

One launch of four gloo ranks on the CPU (``tests/_torch_dist_worker.py``)
runs ``frame_block_sharded``, ``reloc_block_sharded`` and
``global_block_ring`` at (data, context, model) = (1, 1, 2), (1, 1, 4),
(2, 1, 2) and (1, 2, 2) (the last, for the global block, the ring with the
head split), and a block whose 3 heads the model extent of 2 does not
divide (JAX's fallback to the plain block). The references are JAX's
functions under ``make_mesh`` of the same extents on the virtual CPU
devices (JAX's ``_block_tp``, ``_block_ctx_tp`` and ``global_block_ring``):
outputs and the gradients of sum(out ** 2) in x, every parameter and the
context, fp32, atol 1e-5. The gradients of the leaves read inside a
column-parallel branch (LN1, the qk-norms, LN2) are the ones a missing sum
over ``model`` would get wrong. The weights come from JAX's ``init_block``
(with the norms, biases and layer scales moved off their initial values,
so that each leaf's gradient is its own) through
``convert.from_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.layers import rope as JR
from self_supervise_sfm_tpu.layers.block import BlockConfig, init_block
from self_supervise_sfm_tpu.parallel import sharding as JSh
from self_supervise_sfm_tpu.parallel import sp_block as JSP
from self_supervise_sfm_tpu_torch import convert
from tests._torch_dist_worker import launch, load_tree, save_tree

torch.set_num_threads(1)

ATOL = 1e-5
WORLD = 4
DIM, HEADS = 64, 4
CFG = BlockConfig(dim=DIM, num_heads=HEADS, qk_norm=True)
CFG3 = BlockConfig(dim=48, num_heads=3, qk_norm=True)
MESHES = [(1, 1, 2), (1, 1, 4), (2, 1, 2), (1, 2, 2)]

# name -> (kind, (data, context, model), block, shapes)
CASES = {}
for nd, nc, nm in MESHES:
    tag = f"{nd}x{nc}x{nm}"
    CASES[f"frame_{tag}"] = ("frame", (nd, nc, nm), "block", dict(x=(8, 12, DIM)))
    # scenes over data, or one scene's frames over context
    B = 1 if nc > 1 else 2
    CASES[f"reloc_{tag}"] = ("reloc", (nd, nc, nm), "block", dict(B=B, Q=8 // B))
    CASES[f"global_{tag}"] = ("global", (nd, nc, nm), "block", dict(x=(2, 32, DIM)))
# 3 heads over 2 model ranks: the plain block
CASES["frame_indivisible"] = ("frame", (2, 1, 2), "block3", dict(x=(4, 8, 48)))
CASES["reloc_indivisible"] = ("reloc", (2, 1, 2), "block3", dict(B=2, Q=2))


def rope_tables(n, dim=DIM, heads=HEADS):
    pos = JR.position_grid(2, n // 2) + 1
    return tuple(np.asarray(t) for t in JR.rope_tables(pos, dim // heads, 100.0))


def _inputs(kind, block, shapes, rng):
    dim, heads = (DIM, HEADS) if block == "block" else (48, 3)
    if kind != "reloc":
        x = rng.normal(size=shapes["x"]).astype(np.float32)
        cos, sin = rope_tables(x.shape[1], dim, heads)
        return dict(x=x, cos=cos, sin=sin)
    B, Q = shapes["B"], shapes["Q"]
    x = rng.normal(size=(B * Q, 12, dim)).astype(np.float32)
    ctx = rng.normal(size=(B, 10, dim)).astype(np.float32)
    cos, sin = rope_tables(12, dim, heads)
    ccos, csin = (np.broadcast_to(t, (B,) + t.shape).copy()
                  for t in rope_tables(10, dim, heads))
    return dict(x=x, ctx=ctx, cos=cos, sin=sin, ccos=ccos, csin=csin)


def _jax_case(kind, cfg, mesh, p, inp):
    """JAX's sharded block under ``mesh``: (out, grads of sum(out ** 2))."""
    rope = (jnp.asarray(inp["cos"]), jnp.asarray(inp["sin"]))
    if kind == "reloc":
        rc = (jnp.asarray(inp["ccos"]), jnp.asarray(inp["csin"]))
        fn = lambda p, x, c: JSP.reloc_block_sharded(p, x, c, cfg, rope, rc)  # noqa: E731
        args = (p, inp["x"], inp["ctx"])
    else:
        sharded = JSP.frame_block_sharded if kind == "frame" else JSP.global_block_ring
        fn = lambda p, x: sharded(p, x, cfg, rope)  # noqa: E731
        args = (p, inp["x"])

    def loss(*a):
        out = fn(*a)
        return jnp.sum(out ** 2), out

    with JSh.activate_mesh(mesh):
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    return out, grads


def _perturbed(cfg, key, rng):
    """JAX's init with every norm, bias and layer scale moved off its
    initial value (ones, zeros, 0.01), so that their gradients differ."""
    p = jax.tree.map(np.asarray, jax.jit(lambda k: init_block(k, cfg))(key))

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if node.ndim == 1:
            return (node + 0.1 * rng.normal(size=node.shape)).astype(np.float32)
        return node

    return walk(p)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_block")
    rng = np.random.default_rng(0)
    params = {"block": _perturbed(CFG, jax.random.PRNGKey(0), rng),
              "block3": _perturbed(CFG3, jax.random.PRNGKey(1), rng)}
    for name, jp in params.items():
        save_tree(tmp / f"{name}.npz", convert.from_jax_params(jp))
    cases, refs = [], {}
    for name, (kind, (nd, nc, nm), block, shapes) in CASES.items():
        cfg = CFG if block == "block" else CFG3
        inp = _inputs(kind, block, shapes, rng)
        save_tree(tmp / f"{name}.in.npz", inp)
        cases.append(dict(name=name, kind=kind, mesh=[nd, nc, nm], params=block,
                          dim=cfg.dim, heads=cfg.num_heads))
        mesh = JSh.make_mesh(num_data=nd, num_context=nc, num_model=nm)
        out, grads = _jax_case(kind, cfg, mesh, params[block], inp)
        refs[name] = dict(out=np.asarray(out), params=convert.from_jax_params(
            jax.tree.map(np.asarray, grads[0])), dx=np.asarray(grads[1]))
        if kind == "reloc":
            refs[name]["dctx"] = np.asarray(grads[2])
    launch(dict(cases=cases), WORLD, tmp)
    got = {}
    for case in cases:
        n = int(np.prod(case["mesh"]))
        got[case["name"]] = [load_tree(tmp / f"{case['name']}.r{r}.npz") for r in range(n)]
    return got, refs


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _what(name):
    return ["out", "dx", "params"] + (["dctx"] if CASES[name][0] == "reloc" else [])


@pytest.mark.parametrize("name,what", [(n, w) for n in CASES for w in _what(n)])
def test_tp_block_matches_jax(ranks, name, what):
    got, refs = ranks
    ref = refs[name][what]
    for r, res in enumerate(got[name]):
        if what != "params":
            np.testing.assert_allclose(res[what].numpy(), ref, atol=ATOL, err_msg=f"rank {r}")
            continue
        mine = dict(_leaves(res["params"]))
        assert set(mine) == {path for path, _ in _leaves(ref)}
        for path, want in _leaves(ref):
            np.testing.assert_allclose(mine[path].numpy(), want.numpy(), atol=ATOL,
                                       err_msg=f"rank {r} {path}")


@pytest.mark.parametrize("name", list(CASES))
def test_megatron_body_runs_where_jax_takes_it(ranks, name):
    """Megatron's tail (the all-reduce over ``model``) runs wherever the
    heads and hidden width divide the model extent, and not for the block
    of 3 heads, which takes the plain block with no cut, as JAX's does."""
    got, _ = ranks
    divides = not name.endswith("indivisible")
    for res in got[name]:
        assert bool(res["tp"].item()) == divides
        if not divides:
            assert not bool(res["sharded"].item())


def test_branch_leaves_have_gradients_of_their_own(ranks):
    """The check above would miss a missing sum over ``model`` if the leaves
    read inside the branches had no gradient: each is well above the
    tolerance."""
    _, refs = ranks
    grads = dict(_leaves(refs["frame_1x1x2"]["params"]))
    for path in ("/norm1/scale", "/norm2/bias", "/attn/q_norm/scale", "/attn/k_norm/bias"):
        assert float(np.abs(grads[path].numpy()).max()) > 100 * ATOL, path


class _ModelGroup:
    """A mesh of ``m`` model ranks, as far as the rank-local blocks read it
    before any collective."""

    def __init__(self, m):
        self.shape = {"data": 1, "context": 1, "model": m}


@pytest.mark.parametrize("fn", ["block_local", "qkv_local", "block_with_context_local"])
def test_megatron_body_refuses_whole_weights(fn):
    """The rank-local blocks trust the layout's decision, but Megatron's body
    on whole-width weights at a model extent above 1 would sum m copies of
    every head over ``model``: it raises before any collective. The head
    shard passes the check."""
    from self_supervise_sfm_tpu_torch.layers.block import BlockConfig as TBlockConfig
    from self_supervise_sfm_tpu_torch.layers.block import init_block as t_init_block
    from self_supervise_sfm_tpu_torch.parallel import sp_block as TSP

    cfg = TBlockConfig(dim=DIM, num_heads=HEADS, qk_norm=True)
    p = t_init_block(torch.Generator().manual_seed(0), "cpu", cfg)
    x = torch.zeros(2, 6, DIM)
    call = {"block_local": lambda q, g: TSP.block_local(q, x, cfg, None, g),
            "qkv_local": lambda q, g: TSP.qkv_local(q, x, cfg, None, g),
            "block_with_context_local": lambda q, g: TSP.block_with_context_local(
                q, x, x, cfg, None, None, g)}[fn]
    with pytest.raises(ValueError, match="head shard"):
        call(p, _ModelGroup(2))
    assert TSP._tp_group(TSP.tp_block_params(p, 2, 1), cfg, _ModelGroup(2)) is not None
    assert TSP._tp_group(p, cfg, _ModelGroup(1)) is not None
