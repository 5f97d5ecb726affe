"""PyTorch port: the fp32 trunk with the fused blocks asked for
(``make_config(compute_dtype="float32", fused_qkv="on", fused_mlp="on")``)
as a whole, against the JAX package under the same configuration: the joint
forward, the scene-cache build, ``reloc`` and ``fast_reloc``, and one train
step's loss, metrics and gradients.

JAX's ``make_config`` has no such knob: its blocks take "auto", which off
the TPU runs the unfused chain. The module wraps the JAX config properties
that build the block configs (``AggregatorConfig.block_cfg`` /
``global_block_cfg``, ``ViTConfig.block_cfg``) so that every ViT and
aggregator block takes "on", as the port's ``make_config`` sets it: JAX
then runs its fused functions in fp32 (``custom_vjp``s whose kernels off
the TPU are the reference chains they wrap), the port its fused Functions,
whose wrappers run the kernels' plain versions on CPU tensors.
The plain versions' calls are counted, so that the fused route is shown to
be the one each part took. The suite's tiny config (``TINY`` of
``tests/test_torch_model.py``), weights from the JAX ``init_sailrecon``
through ``convert.from_jax_params``, explicit subsample indices; the step on
two synthetic scenes as ``tests/test_torch_train_step.py`` makes them, with
the camera head's pose branch conditioned as there, so that the residuals
start inside the CDF's range, and JAX's own subsample of the step's key.
JAX compiles each program once for the module. Tolerances: the forward and
serving at ``tests/test_torch_serving.py``'s fp32 ones (summation order,
amplified by the random-init heads' exp / inverse-log activations), the
step at ``tests/test_torch_train_step.py``'s (loss atol 1e-5, metrics rtol
2e-4, every trained gradient rtol 2e-4 / atol 1e-5).
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.data.imc2021 import IMC2021Scenes, stack_scenes
from self_supervise_sfm_tpu.data.synthetic import make_synthetic_dataset
from self_supervise_sfm_tpu.layers import vit as JV
from self_supervise_sfm_tpu.models import aggregator as JA
from self_supervise_sfm_tpu.models import sailrecon as JM
from self_supervise_sfm_tpu.train import loop as JL
from self_supervise_sfm_tpu.train.loss import LossConfig as JLossConfig
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.models import sailrecon as TM
from self_supervise_sfm_tpu_torch.ops import fused_qkv as TFQ
from self_supervise_sfm_tpu_torch.train import loop as TL
from self_supervise_sfm_tpu_torch.train.loss import LossConfig as TLossConfig

torch.set_num_threads(1)

TINY = dict(img_size=28, embed_dim=64, depth=4, num_heads=4, vit_depth=2,
            intermediate_layer_idx=(0, 1, 2, 3))
ON = dict(compute_dtype="float32", fused_qkv="on", fused_mlp="on")
A, Q, RANK, S = 3, 3, 2, 2
P0 = (28 // 14) ** 2
KEYS = ("extrinsic", "intrinsic", "point_map", "xyz_cnf", "depth_map", "dpt_cnf",
        "point_map_by_unprojection", "cam_tokens")
RELOC_KEYS = KEYS + ("xyz_conf_fractions",)
FP32_TOL = dict(rtol=2e-4, atol=1e-4)
UNPROJECTION_TOL = dict(rtol=5e-4, atol=1e-4)
PLAIN = ("fused_ln_qkv_rope_plain", "fused_ln_qkv_plain", "fused_proj_residual_plain",
         "fused_mlp_up_plain", "fused_mlp_down_plain")
TRAIN = dict(max_lr=1e-4, warmup_steps=1, total_steps=100, rank=RANK, num_images=S)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _run(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with LLVM's cheaper code generation
    (as ``tests/test_torch_train_step.py`` compiles its step: the same XLA
    program in less compile time)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})(*args)


def _counted(fn):
    """``fn()`` with the fused wrappers' plain versions counted (the CPU
    route of every fused kernel)."""
    counts = dict.fromkeys(PLAIN, 0)
    saved = {name: getattr(TFQ, name) for name in PLAIN}

    def wrap(name):
        def inner(*a, **k):
            counts[name] += 1
            return saved[name](*a, **k)
        return inner
    try:
        for name in PLAIN:
            setattr(TFQ, name, wrap(name))
        return fn(), counts
    finally:
        for name, f in saved.items():
            setattr(TFQ, name, f)


@pytest.fixture(scope="module")
def jax_on():
    """JAX's ViT and aggregator blocks with fused_qkv="on", fused_mlp="on"
    for the module."""
    mp = pytest.MonkeyPatch()
    for cls, name in ((JA.AggregatorConfig, "block_cfg"), (JA.AggregatorConfig,
                                                           "global_block_cfg"),
                      (JV.ViTConfig, "block_cfg")):
        made = getattr(cls, name).fget
        mp.setattr(cls, name, property(lambda self, made=made: dataclasses.replace(
            made(self), fused_qkv="on", fused_mlp="on")))
    cfg = JM.make_config(**TINY)
    for b in (cfg.aggregator.block_cfg, cfg.aggregator.global_block_cfg,
              cfg.aggregator.vit.block_cfg):
        assert (b.fused_qkv, b.fused_mlp) == ("on", "on")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def model(jax_on):
    rng = np.random.default_rng(0)
    jcfg = JM.make_config(**TINY)
    jp = _run(lambda k: JM.init_sailrecon(k, jcfg), jax.random.PRNGKey(0))
    uniq = rng.uniform(size=(1, A, 28, 28, 3)).astype(np.float32)
    queries = rng.uniform(size=(1, Q, 28, 28, 3)).astype(np.float32)
    idx = np.stack([rng.permutation(P0)[:RANK] for _ in range(4 * A)])
    idx = idx.reshape(4, 1, A, RANK).astype(np.int32)
    return dict(jcfg=jcfg, jp=jp, tp=convert.from_jax_params(jax.tree.map(np.asarray, jp)),
                tcfg=TM.make_config(**TINY, **ON), images=np.concatenate([uniq, uniq], axis=1),
                anchors=uniq, queries=queries, idx=idx)


def _forward(m):
    j = _run(lambda p, x, i: JM.forward(p, m["jcfg"], x, A, Q, rank=RANK,
                                        subsample_indices=i, images_duplicated=True),
             m["jp"], jnp.asarray(m["images"]), jnp.asarray(m["idx"]))
    t, counts = _counted(lambda: TM.forward(
        m["tp"], m["tcfg"], m["images"], A, Q, rank=RANK,
        subsample_indices=torch.from_numpy(m["idx"]), images_duplicated=True, device="cpu"))
    # every ViT block once, each aggregator layer's frame, reloc and global
    # blocks (the joint forward runs the reloc blocks on its queries)
    depth, vit = TINY["depth"], TINY["vit_depth"]
    blocks = vit + 3 * depth
    want = {"fused_ln_qkv_rope_plain": 3 * depth, "fused_ln_qkv_plain": vit,
            "fused_proj_residual_plain": blocks, "fused_mlp_up_plain": blocks,
            "fused_mlp_down_plain": blocks}
    return _np(j), t, counts, want, KEYS


@pytest.fixture(scope="module")
def serving(model):
    m = model
    jcache, jcam = _run(lambda p, x, i: JM.build_scene_cache(
        p, m["jcfg"], x, rank=RANK, subsample_indices=i),
        m["jp"], jnp.asarray(m["anchors"]), jnp.asarray(m["idx"]))
    (tcache, tcam), n_build = _counted(lambda: TM.build_scene_cache(
        m["tp"], m["tcfg"], m["anchors"], rank=RANK,
        subsample_indices=torch.from_numpy(m["idx"]), device="cpu"))
    out = {"build": ({"kv": _np(jcache["kv"]), "cam": _np(jcam)},
                     {"kv": tcache["kv"], "cam": tcam}, n_build)}
    for name, kw in (("reloc", {}), ("fast_reloc", dict(fast_reloc=True))):
        j = _run(lambda p, c, t, x, kw=kw: JM.reloc(p, m["jcfg"], c, t, x, **kw),
                 m["jp"], jcache, jcam, jnp.asarray(m["queries"]))
        t, n = _counted(lambda kw=kw: TM.reloc(m["tp"], m["tcfg"], tcache, tcam, m["queries"],
                                                device="cpu", **kw))
        out[name] = (_np(j), t, n)
    return out


def _serving_want(part):
    depth, vit = TINY["depth"], TINY["vit_depth"]
    # build: the ViT on the anchors, frame and global blocks (the context K/V
    # unfused); reloc: the ViT on the queries, frame and reloc blocks
    blocks = vit + 2 * depth
    return {"fused_ln_qkv_rope_plain": 2 * depth, "fused_ln_qkv_plain": vit,
            "fused_proj_residual_plain": blocks, "fused_mlp_up_plain": blocks,
            "fused_mlp_down_plain": blocks}


@pytest.fixture(scope="module")
def step(model):
    """One step's loss, metrics and gradients: JAX's ``_loss_fn`` under
    ``jax.value_and_grad`` with the step's subsample key, the port's
    ``loss_and_grads`` with JAX's subsample of that key."""
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_dataset(root, num_scenes=2, num_images=3, image_size=(40, 32))
        ds = IMC2021Scenes(root, sample_num=128, num_images=S, target_size=28)
        rng = np.random.default_rng(0)
        batch = stack_scenes([ds.load_scene(i, rng) for i in range(2)])
    jcfg, params = model["jcfg"], model["jp"]
    jtcfg = JL.TrainConfig(**TRAIN, loss=JLossConfig(num_bins=50))
    # the pose branch's output layer scaled by 0.01, its bias set so that the
    # 4 iterations sum to a unit quaternion and 1 rad fields of view
    fc2 = params["camera_head"]["pose_branch"]["fc2"]
    fc2 = {"w": 0.01 * fc2["w"], "b": (0.01 * fc2["b"]).at[jnp.array([3, 7, 8])].set(0.25)}
    head = {**params["camera_head"],
            "pose_branch": {**params["camera_head"]["pose_branch"], "fc2": fc2}}
    params = {**params, "camera_head": head}
    key = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    (jloss, jmetrics), jgrads = _run(jax.value_and_grad(
        lambda p, b, k: JL._loss_fn(p, jcfg, jtcfg, b, k), has_aux=True), params, jb, key)
    idx = JA._subsample_indices(key, jcfg.aggregator, 2, S, P0, RANK)
    idx = torch.from_numpy(np.asarray(idx)[..., 5:] - 5)  # patch-relative
    tcfg = TM.make_config(**TINY, **ON)
    ttcfg = TL.TrainConfig(**TRAIN, loss=TLossConfig(num_bins=50))
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, params))
    (tloss, tmetrics, tgrads), counts = _counted(lambda: TL.loss_and_grads(
        tparams, tcfg, ttcfg, TL.batch_to_device(batch, "cpu"), idx))
    jgrads = convert.from_jax_params(jax.tree.map(np.asarray, jgrads))
    return dict(jloss=float(jloss), jmetrics={k: float(v) for k, v in jmetrics.items()},
                jgrads={k: jgrads[k] for k in ("aggregator", "camera_head")},
                tloss=float(tloss), tmetrics={k: float(v) for k, v in tmetrics.items()},
                tgrads=tgrads, counts=counts)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


def _compare(out, ref, keys):
    for k in keys:
        a, b = out[k].float().numpy(), ref[k]
        assert a.shape == b.shape, k
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=k)
        tol = UNPROJECTION_TOL if k == "point_map_by_unprojection" else FP32_TOL
        np.testing.assert_allclose(a[fin], b[fin], err_msg=k, **tol)
    for a, b in zip(out["pose_enc_list"], ref["pose_enc_list"]):
        np.testing.assert_allclose(a.float().numpy(), b, **FP32_TOL)
    assert len(out["pose_enc_list"]) == len(ref["pose_enc_list"])


@pytest.mark.parametrize("part", ["forward", "build", "reloc", "fast_reloc", "step"])
def test_fp32_fused_on_matches_jax(model, serving, step, part):
    """Each part of the slice on the fused route (the plain versions' calls
    as the trunk's blocks require them) against JAX under the same
    configuration."""
    if part == "forward":
        ref, out, counts, want, keys = _forward(model)
        assert counts == want
        _compare(out, ref, keys)
    elif part == "build":
        ref, out, counts = serving["build"]
        assert counts == _serving_want(part)
        assert out["kv"].dtype == torch.float32
        for k in ("kv", "cam"):
            np.testing.assert_allclose(out[k].numpy(), ref[k], err_msg=k, **FP32_TOL)
    elif part in ("reloc", "fast_reloc"):
        ref, out, counts = serving[part]
        assert counts == _serving_want(part)
        _compare(out, ref, RELOC_KEYS if part == "reloc" else ("extrinsic", "intrinsic"))
    else:
        s = step
        assert s["jloss"] < 2.0  # inside the CDF's range
        assert s["counts"]["fused_mlp_up_plain"] > 0
        assert s["tloss"] == pytest.approx(s["jloss"], abs=1e-5)
        assert set(s["tmetrics"]) == set(s["jmetrics"])
        for k, v in s["jmetrics"].items():
            assert s["tmetrics"][k] == pytest.approx(v, rel=2e-4, abs=1e-5), k
        ref = dict(_leaves(s["jgrads"]))
        got = _leaves(s["tgrads"])
        assert len(got) == len(ref) and any(float(g.abs().max()) > 0 for _, g in got)
        for path, g in got:
            np.testing.assert_allclose(g.numpy(), ref[path].numpy(), rtol=2e-4, atol=1e-5,
                                       err_msg=path)
