"""PyTorch port at head dim 128, training: the train step against JAX's.

The model of ``tests/test_torch_head_dim128.py`` (``MODEL``: ``embed_dim=256,
num_heads=2``, heads 128 wide, the ViT's too) takes two train steps (the first at learning rate 0) on each side,
as ``tests/test_torch_train_step.py`` takes them at head dim 64: the JAX
state drawn by ``init_train_state`` and conditioned as that file conditions
it, carried to the port by ``convert.train_state_from_jax``; the port with
the JAX step's own scene-token subsample and on its kernel route (flash
attention, the frame-context Function, the fused block Functions, whose
wrappers run their plain versions on the CPU: on the card the same calls
launch the head dim 128 kernels, B9 among them) where JAX runs its dense
reference. The loss, every metric, every gradient and the new parameters
are compared at ``tests/test_torch_train_step.py``'s tolerances; the port's
backward is counted at head dim 128. Every aggregator layer holds a frame, a
reloc (frame-context) and a global site; the depth is 4, the smallest with
the four distinct taps the JAX package's DPT heads take (with repeated taps
at depth 1 or 2 JAX's step drew gradients of ~1e-5 and a loss that does
not move with the trunk, where the port's and JAX's at depth 4 agree).

JAX compiles its init and its step once for the module, on the CPU.
"""

import tempfile

import jax
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
from self_supervise_sfm_tpu_torch.train import loop as TL
from self_supervise_sfm_tpu_torch.train.loss import LossConfig as TLossConfig
from tests.test_torch_head_dim128 import MODEL
from tests.test_torch_train_step import (B1, TRAINED, _adam, _compile, _condition,
                                         _leaves_with_paths)

torch.set_num_threads(1)

D = 128
IMG, S, RANK = 28, 2, 2
P0 = (IMG // 14) ** 2
KW = MODEL
TRAIN = dict(max_lr=1e-4, warmup_steps=1, total_steps=100, rank=RANK, num_images=S)
PORT_ROUTE = dict(attn_impl="flash", global_attn_impl="flash", fused_qkv="on",
                  fused_mlp="on")
STEPS = 2


@pytest.fixture(scope="module")
def batch():
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_dataset(root, num_scenes=2, num_images=3, image_size=(40, 32))
        ds = IMC2021Scenes(root, sample_num=128, num_images=S, target_size=IMG)
        rng = np.random.default_rng(0)
        return stack_scenes([ds.load_scene(i, rng) for i in range(2)])


@pytest.fixture(scope="module")
def jax_run(batch):
    """Two JAX steps from a conditioned ``init_train_state``; the gradients
    read back from the first moment, as ``tests/test_torch_train_step.py``
    reads them."""
    cfg = JM.make_config(attn_impl="dense", **KW)
    assert cfg.aggregator.head_dim == D
    tcfg = JL.TrainConfig(**TRAIN, loss=JLossConfig(num_bins=50))
    key0 = jax.random.PRNGKey(0)
    state = _condition(_compile(lambda k: JL.init_train_state(k, cfg, tcfg), key0)(key0))
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
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


@pytest.fixture(scope="module")
def port_run(batch, jax_run):
    """The port's two steps on the kernel route; every backward through B9
    counted with its head dim."""
    cfg = TM.make_config(**PORT_ROUTE, **KW)
    tcfg = TL.TrainConfig(**TRAIN, loss=TLossConfig(num_bins=50))
    state = convert.train_state_from_jax(jax_run["states"][0])
    step = TL.make_train_step(cfg, tcfg, device="cpu")
    head_dims = []
    orig = TFA.flash_bwd

    def counted(q, *args, **kw):
        head_dims.append(q.shape[-1])
        return orig(q, *args, **kw)

    run = {"metrics": [], "grads": [], "params": [], "bwd_head_dims": head_dims}
    TFA.flash_bwd = counted
    try:
        for i in range(STEPS):
            idx = torch.from_numpy(jax_run["idx"][i])
            _, _, grads = TL.loss_and_grads(state["params"], cfg, tcfg,
                                            TL.batch_to_device(batch, "cpu"), idx)
            state, metrics = step(state, batch, subsample_indices=idx)
            run["grads"].append(grads)
            run["metrics"].append({k: float(v) for k, v in metrics.items()})
            run["params"].append([t.clone() for t in TL._flatten(state["params"])])
    finally:
        TFA.flash_bwd = orig
    return run


@pytest.mark.parametrize("step", range(STEPS))
def test_d128_step_loss_and_metrics_match_jax(jax_run, port_run, step):
    ref, got = jax_run["metrics"][step], port_run["metrics"][step]
    assert set(got) == set(ref)
    assert ref["loss"] < 2.0 and ref["grad_norm_camera"] > 0  # inside the CDF's range
    for key in ("loss", "loss_cdf_exact", "loss_cdf_approx"):
        assert got[key] == pytest.approx(ref[key], abs=1e-5), key
    for key in set(ref) - {"loss", "loss_cdf_exact", "loss_cdf_approx"}:
        assert got[key] == pytest.approx(ref[key], rel=2e-4, abs=1e-12), key
    assert got["learning_rate"] == (0.0 if step == 0 else pytest.approx(1e-4))


@pytest.mark.parametrize("step", range(STEPS))
def test_d128_step_gradients_match_jax(jax_run, port_run, step):
    """Every trained leaf's gradient (the qk-norm scales (128,) among them),
    rtol 2e-4 / atol 1e-5."""
    ref = dict(_leaves_with_paths(jax_run["grads"][step]))
    got = _leaves_with_paths(port_run["grads"][step])
    assert len(got) == len(ref)
    qn = [g for path, g in got if path.endswith("q_norm/scale")]
    assert qn and all(tuple(g.shape) == (D,) for g in qn)
    for path, g in got:
        np.testing.assert_allclose(g.numpy(), ref[path].numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("step", range(STEPS))
def test_d128_step_new_params_match_jax(jax_run, port_run, step):
    ref = TL._flatten(convert.from_jax_params(jax_run["states"][step + 1]["params"]))
    got = port_run["params"][step]
    assert len(ref) == len(got)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    if step == 0:  # learning rate 0: nothing moved
        start = TL._flatten(convert.from_jax_params(jax_run["states"][0]["params"]))
        assert all(torch.equal(a, b) for a, b in zip(got, start))


def test_d128_step_runs_every_backward_through_b9_at_d128(port_run):
    """A step's gradient evaluation and the step itself (no remat: v + 4d
    flash backwards each, the frame-context split's two included) run
    every attention backward through B9 at head dim 128: nothing of the
    trunk's attention differentiated densely."""
    d, v = KW["depth"], KW["vit_depth"]
    assert port_run["bwd_head_dims"] == [D] * (2 * STEPS * (v + 4 * d))
