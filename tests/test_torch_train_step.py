"""PyTorch port, training slice: the train step against the JAX package's.

A tiny model (``make_config`` as ``tests/test_train_step.py`` sizes it) and a
batch of two synthetic scenes (``make_synthetic_dataset`` +
``IMC2021Scenes``, 128 correspondences a pair). The JAX side draws its train
state with ``init_train_state``; the camera head's pose branch is
conditioned as the JAX package's golden loss test conditions its reference
model, so the residuals start inside the CDF's range; the port takes the
same state through ``convert.train_state_from_jax``. Each side takes two
steps (the first at learning rate 0) from there, the port with the JAX
step's own scene-token subsample (``_subsample_indices`` of
``fold_in(key, step)``), and on its kernel route (flash attention, the
frame-context Function and the fused block Functions, which run their plain
versions on the CPU) where the JAX side runs its dense reference. The loss,
every metric, every gradient and the new parameters are compared.

Tolerances: loss and its parts atol 1e-5; metrics and gradients rtol 2e-4
(summation order through 4 + 2 layers in fp32, then the pose decode); new
parameters atol 1e-6 (Adam moves them by ~lr = 1e-4 along m / sqrt(v), whose
sign and size the gradients' last bits barely move).
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.data.imc2021 import IMC2021Scenes, stack_scenes
from self_supervise_sfm_tpu.data.synthetic import make_synthetic_dataset
from self_supervise_sfm_tpu.models import aggregator as JA
from self_supervise_sfm_tpu.models import sailrecon as JM
from self_supervise_sfm_tpu.train import loop as JL
from self_supervise_sfm_tpu.train.loss import LossConfig as JLossConfig
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.models import sailrecon as TM
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA
from self_supervise_sfm_tpu_torch.ops import fused_qkv as TFQ
from self_supervise_sfm_tpu_torch.train import loop as TL
from self_supervise_sfm_tpu_torch.train.loss import LossConfig as TLossConfig

torch.set_num_threads(1)

IMG, S, RANK = 28, 2, 2
P0 = (IMG // 14) ** 2
KW = dict(img_size=IMG, embed_dim=64, depth=4, num_heads=4, vit_depth=2,
          intermediate_layer_idx=(0, 1, 2, 3))
TRAIN = dict(max_lr=1e-4, warmup_steps=1, total_steps=100, rank=RANK, num_images=S)
B1 = 0.9
TRAINED = ("aggregator", "camera_head")  # the subtrees the loss reaches
PORT_ROUTE = dict(attn_impl="flash", global_attn_impl="flash", fused_qkv="on",
                  fused_mlp="on")
STEPS = 2


def _jax_train_cfg():
    return JL.TrainConfig(**TRAIN, loss=JLossConfig(num_bins=50))


def _port_train_cfg():
    return TL.TrainConfig(**TRAIN, loss=TLossConfig(num_bins=50))


@pytest.fixture(scope="module")
def batch():
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_dataset(root, num_scenes=2, num_images=3, image_size=(40, 32))
        ds = IMC2021Scenes(root, sample_num=128, num_images=S, target_size=IMG)
        rng = np.random.default_rng(0)
        return stack_scenes([ds.load_scene(i, rng) for i in range(2)])


def _condition(state):
    """The pose branch's output layer scaled by 0.01 and its bias set so the
    4 iterations sum to a unit quaternion and 1 rad fields of view."""
    fc2 = state["params"]["camera_head"]["pose_branch"]["fc2"]
    b = (0.01 * fc2["b"]).at[jnp.array([3, 7, 8])].set(0.25)
    fc2 = {"w": 0.01 * fc2["w"], "b": b}
    head = {**state["params"]["camera_head"],
            "pose_branch": {**state["params"]["camera_head"]["pose_branch"], "fc2": fc2}}
    return {**state, "params": {**state["params"], "camera_head": head}}


@pytest.fixture(scope="module")
def jax_run(batch):
    """Two steps of ``make_train_step``'s step function, jitted, from a state
    ``init_train_state`` draws (jitted too, as ``bench.py`` draws it). The
    step returns no gradients; with a zero-initialised fp32 first moment
    they are exact functions of it: m1 = (1 - b1) g0, m2 = b1 m1 + (1 - b1)
    g1, read back in float64 (one fp32 rounding of m, a relative 1e-7 to
    1e-6 of g), so one compiled step serves."""
    cfg, tcfg = JM.make_config(attn_impl="dense", **KW), _jax_train_cfg()
    key0 = jax.random.PRNGKey(0)
    state = _compile(lambda k: JL.init_train_state(k, cfg, tcfg), key0)(key0)
    state = _condition(state)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    step = _compile(JL.make_train_step(cfg, tcfg, jit_compile=False), state, jb)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    run = {"states": [to_np(state)], "metrics": [], "grads": [], "idx": []}
    for _ in range(STEPS):
        key = jax.random.fold_in(state["key"], state["step"])
        idx = JA._subsample_indices(key, cfg.aggregator, 2, S, P0, RANK)
        run["idx"].append(np.asarray(idx)[..., 5:] - 5)  # patch-relative
        state, metrics = step(state, jb)
        run["states"].append(to_np(state))
        run["metrics"].append({k: float(v) for k, v in metrics.items()})
    mus = [_adam(s)[0] for s in run["states"]]
    for i in range(STEPS):
        grads = jax.tree.map(
            lambda m1, m0: (m1.astype(np.float64) - B1 * m0.astype(np.float64)) / (1 - B1),
            {k: mus[i + 1][k] for k in TRAINED}, {k: mus[i][k] for k in TRAINED})
        run["grads"].append(convert.from_jax_params(grads))
    return run


def _compile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with LLVM's cheaper code
    generation: the same XLA program, a third less compile time (the train
    step and the init are the file's largest cost)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


def _adam(state):
    """(mu, nu) of a JAX train state's optax chain."""
    adam = [s for s in state["opt_state"] if hasattr(s, "mu")][0]
    return adam.mu, adam.nu


def _port_steps(batch, jax_run):
    cfg, tcfg = TM.make_config(**PORT_ROUTE, **KW), _port_train_cfg()
    state = convert.train_state_from_jax(jax_run["states"][0])
    step = TL.make_train_step(cfg, tcfg, device="cpu")
    run = {"metrics": [], "grads": [], "params": []}
    for i in range(STEPS):
        idx = torch.from_numpy(jax_run["idx"][i])
        _, _, grads = TL.loss_and_grads(state["params"], cfg, tcfg,
                                        TL.batch_to_device(batch, "cpu"), idx)
        state, metrics = step(state, batch, subsample_indices=idx)
        run["grads"].append(grads)
        run["metrics"].append({k: float(v) for k, v in metrics.items()})
        run["params"].append([t.clone() for t in TL._flatten(state["params"])])
    return run


@pytest.fixture(scope="module")
def port_run(batch, jax_run):
    return _port_steps(batch, jax_run)


def _leaves_with_paths(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves_with_paths(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves_with_paths(v, f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


@pytest.mark.parametrize("step", range(STEPS))
def test_step_loss_and_metrics_match_jax(jax_run, port_run, step):
    ref, got = jax_run["metrics"][step], port_run["metrics"][step]
    assert set(got) == set(ref)
    assert ref["loss"] < 2.0 and ref["grad_norm_camera"] > 0  # inside the CDF's range
    for key in ("loss", "loss_cdf_exact", "loss_cdf_approx"):
        assert got[key] == pytest.approx(ref[key], abs=1e-5), key
    for key in set(ref) - {"loss", "loss_cdf_exact", "loss_cdf_approx"}:
        assert got[key] == pytest.approx(ref[key], rel=2e-4, abs=1e-12), key
    assert got["learning_rate"] == (0.0 if step == 0 else pytest.approx(1e-4))


@pytest.mark.parametrize("step", range(STEPS))
def test_step_gradients_match_jax(jax_run, port_run, step):
    """Every trained leaf's gradient (the aggregator's and the camera
    head's), rtol 2e-4 / atol 1e-5."""
    ref = dict(_leaves_with_paths(jax_run["grads"][step]))
    got = _leaves_with_paths(port_run["grads"][step])
    assert len(got) == len(ref)
    for path, g in got:
        np.testing.assert_allclose(g.numpy(), ref[path].numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("step", range(STEPS))
def test_step_new_params_match_jax(jax_run, port_run, step):
    ref = TL._flatten(convert.from_jax_params(jax_run["states"][step + 1]["params"]))
    got = port_run["params"][step]
    assert len(ref) == len(got)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    if step == 0:  # learning rate 0: nothing moved
        start = TL._flatten(convert.from_jax_params(jax_run["states"][0]["params"]))
        assert all(torch.equal(a, b) for a, b in zip(got, start))


def test_jax_dpt_head_gradients_are_zero(jax_run):
    """Nothing of the loss reads the DPT heads: JAX's gradients for them are
    exactly zero (their first moment stays exactly 0, where any gradient
    above fp32's smallest subnormals would show), which is why the port
    neither runs nor updates them."""
    for state in jax_run["states"][1:]:
        mu, _ = _adam(state)
        for head in ("depth_head", "point_head"):
            leaves = jax.tree.leaves(mu[head])
            assert leaves and all(not np.any(t) for t in leaves), head


def test_train_state_from_jax_is_bit_exact(jax_run):
    """The stepped JAX state (nonzero moments) converts bit for bit, with its
    first moment in fp32 and in bf16 (as ``adam_mu_dtype="bfloat16"``
    stores it): params and nu fp32, mu in its dtype, the count and the
    step."""
    js = jax_run["states"][-1]
    mu, nu = _adam(js)
    ref = [TL._flatten(convert.from_jax_params(t)) for t in (js["params"], mu, nu)]
    for mu_dtype in (torch.float32, torch.bfloat16):
        state = js
        if mu_dtype == torch.bfloat16:
            state = {**js, "opt_state": tuple(
                s._replace(mu=jax.tree.map(lambda t: t.astype(jnp.bfloat16), s.mu))
                if hasattr(s, "mu") else s for s in js["opt_state"])}
        ts = convert.train_state_from_jax(state)
        assert ts["step"] == STEPS and ts["opt"]["count"] == STEPS
        trees = (ts["params"], ts["opt"]["mu"], ts["opt"]["nu"])
        for tree, r, dtype in zip(trees, ref, (torch.float32, mu_dtype, torch.float32)):
            got = TL._flatten(tree)
            assert len(got) == len(r) > 0
            for a, b in zip(got, r):
                assert a.dtype == dtype and torch.equal(a, b.to(dtype))
        assert any(bool((t != 0).any()) for t in TL._flatten(ts["opt"]["mu"]))


def test_remat_gives_bit_equal_gradients(batch, jax_run):
    """``remat`` (the aggregator layers and ViT blocks under
    ``torch.utils.checkpoint``) recomputes the same arithmetic: the loss and
    every gradient are bit-equal with it on and off."""
    tcfg = _port_train_cfg()
    state = convert.train_state_from_jax(jax_run["states"][0])
    idx = torch.from_numpy(jax_run["idx"][0])
    out = []
    for remat in (False, True):
        cfg = TM.make_config(**PORT_ROUTE, **KW, remat=remat, vit_remat=remat)
        out.append(TL.loss_and_grads(state["params"], cfg, tcfg,
                                     TL.batch_to_device(batch, "cpu"), idx))
    (la, _, ga), (lb, _, gb) = out
    assert torch.equal(la, lb)
    for a, b in zip(TL._flatten(ga), TL._flatten(gb)):
        assert torch.equal(a, b)


def test_step_launch_counts_match_the_prediction(batch, jax_run, monkeypatch):
    """The counts ``chip_smoke.py`` asserts on the card, here as calls of the
    wrappers (their plain versions run on the CPU): with d aggregator layers,
    v ViT blocks and the layers rematerialised, one step makes v + 6d flash
    forwards, 2d frame-context forwards, 6d LN+QKV+RoPE, v LN+QKV, v + 6d of
    each other fused kernel and v + 4d flash backwards."""
    calls = {}

    def spy(mod, name):
        orig = getattr(mod, name)
        calls[name] = 0

        def wrapped(*a, **k):
            calls[name] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for name in ("flash_fwd", "frame_ctx_fwd", "flash_bwd", "flash_fwd_reloc",
                 "frame_ctx_packed_fwd"):
        spy(TFA, name)
    for name in ("fused_ln_qkv_rope_fwd", "fused_ln_qkv_fwd", "fused_proj_residual_fwd",
                 "fused_mlp_up", "fused_mlp_down"):
        spy(TFQ, name)
    cfg = TM.make_config(**PORT_ROUTE, **KW, remat=True)
    step = TL.make_train_step(cfg, _port_train_cfg(), device="cpu")
    step(convert.train_state_from_jax(jax_run["states"][0]), batch,
         subsample_indices=torch.from_numpy(jax_run["idx"][0]))
    d, v = KW["depth"], KW["vit_depth"]
    assert calls == {"flash_fwd": v + 6 * d, "frame_ctx_fwd": 2 * d, "flash_bwd": v + 4 * d,
                     "flash_fwd_reloc": 0, "frame_ctx_packed_fwd": 0,
                     "fused_ln_qkv_rope_fwd": 6 * d, "fused_ln_qkv_fwd": v,
                     "fused_proj_residual_fwd": v + 6 * d, "fused_mlp_up": v + 6 * d,
                     "fused_mlp_down": v + 6 * d}
