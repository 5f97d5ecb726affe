"""PyTorch port: training's parameter layout (``parallel/sharding.py``)
against the JAX package's ``param_sharding``.

The rule is pure: on JAX's own full-width train state (``jax.eval_shape``
of ``init_train_state``: shapes, no compute), the port's
``param_sharding`` / ``leaf_spec`` give JAX's spec for every leaf under
FSDP, TP and both, at data and model extents of 2 and 4. JAX's stacked
layers and the port's per-layer lists are cut differently by the same rule
(a (24, 4096) stacked fc1 bias is cut, a per-layer (4096,) one is not); on
the port's own tree the per-rank state bytes are what ``chip_smoke.py``
phase 10 prints. ``tests/test_tp.py``'s rule checks are mirrored on the
port's trees. The flat-buffer collectives run on a gloo group of one rank:
their views keep each tensor's strides and values.
"""

import jax
import pytest
import torch
import torch.distributed as dist

from self_supervise_sfm_tpu.models import sailrecon as JM
from self_supervise_sfm_tpu.parallel import sharding as JSh
from self_supervise_sfm_tpu.train import loop as JL
from self_supervise_sfm_tpu_torch.models import sailrecon as TM
from self_supervise_sfm_tpu_torch.parallel import sharding as Sh
from self_supervise_sfm_tpu_torch.train import loop as TL

# (fsdp, tp, data extent, model extent); each mesh fits the 8 virtual devices
RULES = {"fsdp-2": (True, False, 2, 1), "fsdp-4": (True, False, 4, 1),
         "tp-2": (False, True, 1, 2), "tp-4": (False, True, 1, 4),
         "both-2x2": (True, True, 2, 2), "both-4x2": (True, True, 4, 2),
         "both-2x4": (True, True, 2, 4)}


@pytest.fixture(scope="module")
def jax_state():
    """JAX's full-width train state as shapes (bf16 Adam mu, as phase 10)."""
    cfg = JM.make_config()
    tcfg = JL.TrainConfig(adam_mu_dtype="bfloat16")
    return jax.eval_shape(lambda k: JL.init_train_state(k, cfg, tcfg), jax.random.PRNGKey(0))


def _port_path(path):
    """A JAX key path as the port's: dict keys as strings, anything else
    (sequence indices, namedtuple fields) as a non-string entry."""
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            out.append(k.key)
        elif isinstance(k, jax.tree_util.SequenceKey):
            out.append(k.idx)
        else:
            out.append(("attr", getattr(k, "name", repr(k))))
    return tuple(out)


@pytest.mark.parametrize("rule", RULES)
def test_every_leaf_of_the_jax_state_gets_jax_spec(jax_state, rule):
    fsdp, tp, nd, nm = RULES[rule]
    mesh = JSh.make_mesh(num_data=nd, num_context=1, num_model=nm)
    ref = JSh.param_sharding(mesh, jax_state, fsdp=fsdp, tp=tp)
    leaves = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    specs = jax.tree.leaves(ref, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(specs) > 0
    cut = 0
    for (path, x), sh in zip(leaves, specs):
        got = Sh.leaf_spec(_port_path(path), x.shape, nd if fsdp else 1, nm if tp else 1)
        want = tuple(sh.spec) + (None,) * (len(x.shape) - len(sh.spec))
        assert got == want, jax.tree_util.keystr(path)
        cut += any(a is not None for a in got)
    assert cut > 20
    # the tree function on JAX's params tree (nested dicts) as it is
    got = Sh.spec_leaves(Sh.param_sharding({"data": nd, "model": nm}, jax_state["params"],
                                           fsdp=fsdp, tp=tp))
    want = [tuple(s.spec) + (None,) * (x.ndim - len(s.spec)) for s, x in zip(
        jax.tree.leaves(JSh.param_sharding(mesh, jax_state["params"], fsdp=fsdp, tp=tp),
                        is_leaf=lambda x: hasattr(x, "spec")),
        jax.tree.leaves(jax_state["params"]))]
    assert got == want


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_megatron_rules():
    """``tests/test_tp.py::TestParamShardingRules::test_megatron_rules`` on
    the port's tree layout."""
    tree = {
        "blocks": {
            "attn": {"qkv": {"w": _meta(4, 64, 192), "b": _meta(4, 192)},
                     "proj": {"w": _meta(4, 64, 64), "b": _meta(4, 64)}},
            "mlp": {"fc1": {"w": _meta(4, 64, 256), "b": _meta(4, 256)},
                    "fc2": {"w": _meta(4, 256, 64), "b": _meta(4, 64)}},
        },
        # a patch-embed conv named "proj" but not under attn: untouched by tp
        "patch_embed": {"proj": {"w": _meta(14, 14, 3, 64)}},
    }
    sh = Sh.param_sharding({"data": 2, "context": 1, "model": 2}, tree, tp=True)
    b = sh["blocks"]
    assert b["attn"]["qkv"]["w"] == (None, None, "model")
    assert b["attn"]["qkv"]["b"] == (None, "model")
    assert b["attn"]["proj"]["w"] == (None, "model", None)
    assert b["attn"]["proj"]["b"] == (None, None)
    assert b["mlp"]["fc1"]["w"] == (None, None, "model")
    assert b["mlp"]["fc2"]["w"] == (None, "model", None)
    assert sh["patch_embed"]["proj"]["w"] == (None, None, None, None)


def test_fsdp_composes_with_tp():
    """tp takes the output dim; fsdp the largest remaining one."""
    tree = {"attn": {"qkv": {"w": _meta(512, 768)}}}
    sh = Sh.param_sharding({"data": 2, "model": 2}, tree, fsdp=True, tp=True)
    assert sh["attn"]["qkv"]["w"] == ("data", "model")


def test_rule_on_the_ports_tree_differs_from_jax_stacked_cut():
    """The same rule on the port's per-layer leaves: a block's fc1 bias
    (4096,) stays whole where JAX's stacked (24, 4096) is cut; the weights
    are cut on their largest dim, as JAX cuts its stacked ones."""
    cfg = TM.make_config()
    specs = Sh.param_sharding({"data": 2}, TL.param_shapes(cfg), fsdp=True)
    blk = specs["aggregator"]["frame_blocks"][0]
    assert blk["mlp"]["fc1"]["b"] == (None,)
    assert blk["mlp"]["fc1"]["w"] == (None, "data")  # (1024, 4096)
    assert blk["mlp"]["fc2"]["w"] == ("data", None)  # (4096, 1024)
    assert blk["attn"]["qkv"]["w"] == (None, "data")  # (1024, 3072)


def test_state_bytes_per_rank_on_the_ports_tree():
    """Phase 10's numbers: the whole state at full width with a bf16 mu is
    14.93 GB; FSDP cuts the 464 leaves of 65,536 elements or more (all but
    ~1.8 M of 1.49 G parameters), so a rank holds a little over 1/n; DDP
    holds the whole on every rank."""
    cfg = TM.make_config()
    leaves = TL._flatten(TL.param_shapes(cfg))
    n_params = sum(t.numel() for t in leaves)
    whole = TL.state_bytes_per_rank(cfg, 1, False, "bfloat16")
    assert whole == n_params * 10 and abs(whole / 1e9 - 14.93) < 0.005
    small = sum(t.numel() for t in leaves if t.numel() < Sh.MIN_SHARD_ELEMS)
    for n in (2, 4, 8):
        assert TL.state_bytes_per_rank(cfg, n, False, "bfloat16") == whole
        got = TL.state_bytes_per_rank(cfg, n, True, "bfloat16")
        assert got == (n_params - small) * 10 // n + small * 10
    assert TL.state_bytes_per_rank(cfg, 1, True, "bfloat16") == whole


def test_a_model_spec_has_no_rank_local_layout():
    """A spec over ``model`` now has its rank-local layout: a qkv leaf's
    part is its heads' columns of q, of k and of v (JAX's
    ``_tp_local_attn`` slice, not the contiguous third of its spec), any
    other leaf's a contiguous part; the parts join back whole; the ``data``
    cut applies to the model part."""
    assert Sh.data_dim((None, "model")) is None and Sh.model_dim((None, "model")) == 1
    assert Sh.data_dim(("data", None)) == 0 and Sh.data_dim((None, None)) is None
    C, H, d, m = 8, 4, 2, 2
    w = torch.arange(C * 3 * C, dtype=torch.float32).reshape(C, 3 * C)
    assert Sh.model_groups(("aggregator", "frame_blocks", 0, "attn", "qkv", "w")) == 3
    assert Sh.model_groups(("aggregator", "frame_blocks", 0, "mlp", "fc1", "w")) == 1
    parts = [Sh.model_part(w, -1, m, i, 3) for i in range(m)]
    hl = H // m
    for i, part in enumerate(parts):
        want = w.reshape(C, 3, H, d)[:, :, i * hl:(i + 1) * hl].reshape(C, 3 * hl * d)
        assert torch.equal(part, want)
    assert torch.equal(Sh.join_model_parts(parts, -1, 3), w)
    fc1 = torch.arange(C * 4 * C, dtype=torch.float32).reshape(C, 4 * C)
    assert torch.equal(Sh.join_model_parts([Sh.model_part(fc1, 1, m, i) for i in range(m)], 1),
                       fc1)
    assert Sh.local_shape((C, 3 * C), ("data", "model"), {"data": 2, "model": m}) == (
        C // 2, 3 * C // m)


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield Sh.make_mesh(1, 1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_buckets_keep_strides_values_and_alignment(world_of_one):
    """A channels-last gradient (a convolution's) comes back with its
    strides; every view starts on a multiple of 128 elements; a bucket
    holds one dtype and at most its bytes."""
    g = torch.Generator().manual_seed(0)
    conv = torch.randn(8, 14, 14, 3, generator=g).permute(0, 3, 1, 2)  # channels-last
    ts = [torch.randn(5, 7, generator=g), conv, torch.randn(300, generator=g),
          torch.randn(2, 3, generator=g).double()]
    ref = [t.clone() for t in ts]
    out = Sh.bucketed_all_reduce(list(ts), world_of_one, ("data", "context"),
                                 bucket_bytes=20000)
    for a, b in zip(out, ref):
        assert torch.equal(a, b) and a.stride() == b.stride() and a.dtype == b.dtype
        assert a.storage_offset() % 128 == 0
    assert [list(r) for r in Sh._buckets(ref, 20000)] == [[0, 1], [2], [3]]


def test_reduce_scatter_and_gather_of_one_rank_are_copies(world_of_one):
    mesh = world_of_one
    g = torch.Generator().manual_seed(1)
    ts = [torch.randn(6, 4, generator=g), torch.randn(3, 8, 2, generator=g).permute(2, 0, 1)]
    dims = [1, 2]
    parts = Sh.bucketed_reduce_scatter([t.clone() for t in ts], dims, mesh)
    for a, b in zip(parts, ts):
        assert torch.equal(a, b) and a.stride() == b.stride()
    wholes = Sh.bucketed_all_gather(ts, dims, mesh)
    assert all(torch.equal(a, b) for a, b in zip(wholes, ts))
    tree = {"a": ts[0], "b": [ts[1]]}
    specs = {"a": (None, "data"), "b": [(None, None, None)]}
    back = Sh.gather_tree(Sh.shard_tree(tree, specs, mesh), specs, mesh, device="cpu")
    assert torch.equal(back["a"], ts[0]) and torch.equal(back["b"][0], ts[1])
