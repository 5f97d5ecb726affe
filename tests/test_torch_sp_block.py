"""PyTorch port: the sharded blocks over gloo ranks vs the JAX package's.

One launch of four gloo ranks on the CPU (``tests/_torch_dist_worker.py``)
runs ``frame_block_sharded``, ``reloc_block_sharded`` and
``global_block_ring`` at (data, context) = (1, 2), (2, 1), (2, 2), (1, 4),
the cases where JAX's gates take the plain block (frames that do not divide,
frames that would land on a rank without their scene, a token axis that
does not divide), and a ``model`` extent of 2, where every sharded block
runs Megatron's body (``tests/test_torch_tp_block.py`` holds it to JAX's). The references are JAX's functions under ``make_mesh`` of the same
extents on the virtual CPU devices: outputs and the gradients of
sum(out ** 2) in x, the parameters and the context (JAX's
``tests/test_sp_block.py`` ``test_grads_match``), fp32, atol 1e-5. The
block's weights come from JAX's ``init_block`` through
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
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]

# name -> (kind, (data, context), shapes); shapes: x's, and for reloc (B, Q)
CASES = {}
for nd, nc in MESHES:
    CASES[f"frame_{nd}x{nc}"] = ("frame", (nd, nc), dict(x=(8, 12, DIM)))
    B = nd
    CASES[f"reloc_{nd}x{nc}"] = ("reloc", (nd, nc), dict(B=B, Q=8 // B))
    CASES[f"global_{nd}x{nc}"] = ("global", (nd, nc), dict(x=(nd, 24, DIM)))
# JAX's fallbacks: 5 frames over 4 ranks; two scenes over context alone; 26
# tokens over 4 context ranks (then one scene over 4 ranks: the plain block)
CASES["frame_fallback"] = ("frame", (2, 2), dict(x=(5, 12, DIM)))
CASES["reloc_misaligned"] = ("reloc", (1, 4), dict(B=2, Q=4))
CASES["global_fallback"] = ("global", (1, 4), dict(x=(1, 26, DIM)))


def rope_tables(n):
    pos = JR.position_grid(2, n // 2) + 1
    return tuple(np.asarray(t) for t in JR.rope_tables(pos, DIM // HEADS, 100.0))


def _inputs(kind, shapes, rng):
    if kind != "reloc":
        x = rng.normal(size=shapes["x"]).astype(np.float32)
        cos, sin = rope_tables(x.shape[1])
        return dict(x=x, cos=cos, sin=sin)
    B, Q = shapes["B"], shapes["Q"]
    x = rng.normal(size=(B * Q, 12, DIM)).astype(np.float32)
    ctx = rng.normal(size=(B, 10, DIM)).astype(np.float32)
    cos, sin = rope_tables(12)
    ccos, csin = (np.broadcast_to(t, (B,) + t.shape).copy() for t in rope_tables(10))
    return dict(x=x, ctx=ctx, cos=cos, sin=sin, ccos=ccos, csin=csin)


def _jax_case(kind, mesh, p, inp):
    """JAX's sharded block under ``mesh``: (out, grads of sum(out ** 2))."""
    rope = (jnp.asarray(inp["cos"]), jnp.asarray(inp["sin"]))
    if kind == "reloc":
        rc = (jnp.asarray(inp["ccos"]), jnp.asarray(inp["csin"]))
        fn = lambda p, x, c: JSP.reloc_block_sharded(p, x, c, CFG, rope, rc)  # noqa: E731
        args = (p, inp["x"], inp["ctx"])
    else:
        sharded = JSP.frame_block_sharded if kind == "frame" else JSP.global_block_ring
        fn = lambda p, x: sharded(p, x, CFG, rope)  # noqa: E731
        args = (p, inp["x"])

    def loss(*a):
        out = fn(*a)
        return jnp.sum(out ** 2), out

    with JSh.activate_mesh(mesh):
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    return out, grads


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_block")
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: init_block(k, CFG))(jax.random.PRNGKey(0)))
    save_tree(tmp / "block.npz", convert.from_jax_params(jp))
    rng = np.random.default_rng(0)
    cases, refs = [], {}
    for name, (kind, (nd, nc), shapes) in CASES.items():
        inp = _inputs(kind, shapes, rng)
        save_tree(tmp / f"{name}.in.npz", inp)
        cases.append(dict(name=name, kind=kind, mesh=[nd, nc, 1], params="block",
                          dim=DIM, heads=HEADS))
        out, grads = _jax_case(kind, JSh.make_mesh(num_data=nd, num_context=nc), jp, inp)
        refs[name] = dict(out=np.asarray(out), params=convert.from_jax_params(
            jax.tree.map(np.asarray, grads[0])), dx=np.asarray(grads[1]))
        if kind == "reloc":
            refs[name]["dctx"] = np.asarray(grads[2])
    save_tree(tmp / "refusals.in.npz", _inputs("reloc", dict(B=1, Q=4), rng))
    cases.append(dict(name="refusals", kind="model_extent", mesh=[1, 1, 2], params="block",
                      dim=DIM, heads=HEADS))
    save_tree(tmp / "mesh.in.npz", dict(images=np.arange(4 * 3, dtype=np.float32).reshape(4, 3)))
    cases.append(dict(name="mesh", kind="mesh", mesh=[2, 2, 1]))
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
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _what(name):
    return ["out", "dx", "params"] + (["dctx"] if CASES[name][0] == "reloc" else [])


@pytest.mark.parametrize("name,what", [(n, w) for n in CASES for w in _what(n)])
def test_sharded_block_matches_jax(ranks, name, what):
    got, refs = ranks
    ref = refs[name][what]
    for r, res in enumerate(got[name]):
        if what != "params":
            np.testing.assert_allclose(res[what].numpy(), ref, atol=ATOL,
                                       err_msg=f"rank {r}")
            continue
        mine = dict(_leaves(res["params"]))
        for path, want in _leaves(ref):
            np.testing.assert_allclose(mine[path].numpy(), want.numpy(), atol=ATOL,
                                       err_msg=f"rank {r} {path}")


@pytest.mark.parametrize("name", list(CASES))
def test_gate_matches_jax(ranks, name):
    """The sharded path runs exactly where JAX's gates take it: the three
    fallback cases run the plain block on every rank, with no cut."""
    got, _ = ranks
    want = not name.endswith(("fallback", "misaligned"))
    for res in got[name]:
        assert bool(res["sharded"].item()) == want


def test_model_extent_refused(ranks):
    """A ``model`` extent of 2 is no longer refused: the three blocks run
    Megatron's body and agree with the plain block (fp32, atol 1e-5), and
    the aggregator's layout is tensor-parallel."""
    got, _ = ranks
    for res in got["refusals"]:
        assert not res["raised"].numpy().astype(bool).any(), res["raised"]
        assert (res["err"].numpy() <= ATOL).all(), res["err"]
        assert bool(res["tp"].item())


def test_make_mesh_without_a_process_group_raises():
    from self_supervise_sfm_tpu_torch.parallel import sharding as TSh

    with pytest.raises(RuntimeError, match="no process group"):
        TSh.make_mesh(1, 1, 1, device="cpu")


def test_mesh_indices_and_shard_batch(ranks):
    """A 2 x 2 mesh: rank r sits at data r // 2, context r % 2; ``shard_batch``
    gives each data rank its half of the scenes (whole on every rank), or
    keeps a process-local batch as it is; non-array leaves pass through;
    extents past the world and a cuda mesh on gloo are refused."""
    got, _ = ranks
    images = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    for r, res in enumerate(got["mesh"]):
        d, c = divmod(r, 2)
        assert res["index"].numpy().tolist() == [d, c, r]
        np.testing.assert_array_equal(res["sharded"].numpy(), images[2 * d: 2 * d + 2])
        np.testing.assert_array_equal(res["local"].numpy(), images)
        assert int(res["scalar"].item()) == 3
        assert res["refused"].numpy().astype(bool).all()
