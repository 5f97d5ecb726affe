"""PyTorch port, trainer slice: ``train/trainer.py:run`` against the JAX
package's, and the port's own checkpoint / resume, curriculum, seeding,
early stop, artifacts and refusals.

The tiny model of ``tests/test_trainer.py`` (28 px, width 64, 4 aggregator
layers, 2 ViT blocks, rank 2) on synthetic scenes at 40 x 32 px, 64
correspondences a pair, fp32. The loss's CDF range is widened to
``max_val=30``: a random tiny model's log residuals are ~17-18, so at the
default 15 every residual saturates (loss 2, zero gradient).

Against JAX: the JAX trainer runs once a module, on one device, with
checkpoints, artifacts and sanity checks off and a validation at its last
step; its starting state (``init_train_state(PRNGKey(seed))``) is captured,
converted with ``convert.train_state_from_jax`` and saved as the port's
step-0 checkpoint, which the port's ``run`` resumes. The port takes JAX's
per-step scene-token subsample (``fold_in(key, step)``) and the
validator's (``PRNGKey(0x5EED)``) through :func:`trainer.step_subsample` and
:func:`validate.eval_subsample`. Tolerances of
``tests/test_torch_train_step.py``: losses atol 1e-5, metrics rtol 2e-4,
final params atol 1e-6; the validator's two means rtol 2e-4.
"""

import json
import os
import signal as _signal
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.data.synthetic import make_synthetic_dataset
from self_supervise_sfm_tpu.models import aggregator as JA
from self_supervise_sfm_tpu.models import sailrecon as JM
from self_supervise_sfm_tpu.train import loop as JL
from self_supervise_sfm_tpu.train import trainer as JT
from self_supervise_sfm_tpu.train.loss import LossConfig as JLossConfig
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.layers.vit import resample_pos_embed
from self_supervise_sfm_tpu_torch.train import loop as TL
from self_supervise_sfm_tpu_torch.train import trainer as TT
from self_supervise_sfm_tpu_torch.train import validate as TV
from self_supervise_sfm_tpu_torch.train.checkpoint import CheckpointManager
from self_supervise_sfm_tpu_torch.train.loss import LossConfig as TLossConfig

torch.set_num_threads(1)

IMG, S, RANK, STEPS, SEED = 28, 2, 2, 3, 0
P0 = (IMG // 14) ** 2
TINY = dict(img_size=IMG, embed_dim=64, depth=4, num_heads=4, vit_depth=2)
TRAIN = dict(max_lr=1e-4, warmup_steps=1, rank=RANK, num_images=S)
LOSS = dict(num_bins=50, max_val=30.0)
COMMON = dict(num_images=S, sample_num=64, compute_dtype="float32", remat=False,
              rank=RANK, seed=SEED, log_every=0, **TINY)
EVAL = dict(eval_num_images=S, eval_sample_num=64)
TIMING = {"step_seconds", "steps_per_sec", "frames_per_sec_per_chip"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("scenes")), num_scenes=2,
                                  num_images=3, image_size=(40, 32))


def _rows(results_dir, prefix="train"):
    with open(os.path.join(results_dir, "tensorboard", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["prefix"] == prefix]


def _port_cfg(root, results_dir, steps, **kw):
    train = TL.TrainConfig(total_steps=steps, loss=TLossConfig(**LOSS), **TRAIN)
    base = dict(data_root=root, results_dir=str(results_dir), total_steps=steps,
                checkpoint_every=0, artifact_every=0, sanity_check_every=0,
                native_loader=False, device="cpu", train=train, **COMMON)
    return TT.TrainerConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_run(root, tmp_path_factory):
    """JAX ``T.run``: 3 steps on one device, validation at step 3."""
    results = str(tmp_path_factory.mktemp("jax_results"))
    cfg = JT.TrainerConfig(
        data_root=root, results_dir=results, total_steps=STEPS, checkpoint_every=0,
        artifact_every=0, sanity_check_every=0, native_loader=False, eval_every=STEPS,
        eval_data_root=root, **EVAL, **COMMON,
        train=JL.TrainConfig(total_steps=STEPS, loss=JLossConfig(**LOSS), **TRAIN))
    captured = {}

    def init_and_capture(key, model_cfg, train_cfg):
        # jitted: one compile in place of one for each primitive
        state = jax.jit(JL.init_train_state, static_argnums=(1, 2))(key, model_cfg, train_cfg)
        captured["state"] = jax.tree.map(np.asarray, state)
        return state

    one = jax.devices()[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a: one)
        mp.setattr(JT, "init_train_state", init_and_capture)
        final = JT.run(cfg)
    mcfg = JM.make_config(**TINY, intermediate_layer_idx=(0, 1, 2, 3))
    key = captured["state"]["key"]

    def patch_relative(k, B):
        return np.asarray(JA._subsample_indices(k, mcfg.aggregator, B, S, P0, RANK))[..., 5:] - 5

    return {
        "state0": captured["state"], "final": jax.tree.map(np.asarray, final),
        "train": _rows(results), "val": _rows(results, "val"),
        "idx": [patch_relative(jax.random.fold_in(key, s), 1) for s in range(STEPS)],
        "eval_idx": patch_relative(jax.random.PRNGKey(TV.EVAL_SEED), 2),
    }


@pytest.fixture(scope="module")
def port_run(root, jax_run, tmp_path_factory):
    results = tmp_path_factory.mktemp("port_results")
    mgr = CheckpointManager(os.path.join(results, "checkpoints"))
    mgr.save(0, convert.train_state_from_jax(jax_run["state0"]))
    mgr.close()
    idx = [torch.from_numpy(i) for i in jax_run["idx"]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TT, "step_subsample",
                   lambda seed, step, device: {"subsample_indices": idx[step]})
        mp.setattr(TV, "eval_subsample", lambda device: {
            "subsample_indices": torch.from_numpy(jax_run["eval_idx"])})
        final = TT.run(_port_cfg(root, results, STEPS, eval_every=STEPS,
                                 eval_data_root=root, **EVAL))
    return {"final": final, "train": _rows(results), "val": _rows(results, "val")}


@pytest.mark.parametrize("step", range(STEPS))
def test_run_losses_and_metrics_match_jax(jax_run, port_run, step):
    ref, got = jax_run["train"][step], port_run["train"][step]
    assert got["step"] == ref["step"] == step + 1
    assert set(got) == set(ref)
    for k in ("loss", "loss_cdf_exact", "loss_cdf_approx"):
        assert got[k] == pytest.approx(ref[k], abs=1e-5), k
    for k in set(ref) - TIMING - {"step", "prefix", "loss", "loss_cdf_exact",
                                  "loss_cdf_approx"}:
        assert got[k] == pytest.approx(ref[k], rel=2e-4, abs=1e-12), k


def test_run_reaches_the_loss_range(jax_run):
    """At least one compared step is inside the CDF's range with a camera
    gradient (the comparison is not of saturated zeros)."""
    assert any(r["loss"] < 2.0 and r["grad_norm_camera"] > 0 for r in jax_run["train"])


def _with_paths(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _with_paths(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _with_paths(v, f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


def test_run_final_params_match_jax(jax_run, port_run):
    ref = dict(_with_paths(convert.from_jax_params(jax_run["final"]["params"])))
    got = _with_paths(port_run["final"]["params"])
    assert len(ref) == len(got) > 0
    for path, a in got:
        np.testing.assert_allclose(a.numpy(), ref[path].numpy(), rtol=0, atol=1e-6,
                                   err_msg=path)
    assert port_run["final"]["step"] == STEPS and port_run["final"]["opt"]["count"] == STEPS


def test_validator_matches_jax(jax_run, port_run):
    (ref,), (got,) = jax_run["val"], port_run["val"]
    assert got["step"] == ref["step"] == STEPS
    for k in ("px_residual", "log_residual"):
        assert got[k] == pytest.approx(ref[k], rel=2e-4), k
    assert got["best_step"] == ref["best_step"] == STEPS


# -- the port's own ----------------------------------------------------------------


def _leaves(state):
    """The params and the Adam moments, in one list."""
    return TL._flatten([state["params"], state["opt"]["mu"], state["opt"]["nu"]])


def test_interrupted_run_resumes_bit_equal(root, tmp_path, monkeypatch):
    """A SIGTERM at step 2 checkpoints at the step edge and stops; a rerun
    resumes there and ends bit-equal to the uninterrupted run: every
    later step's metrics, the params, the moments and the counters."""
    whole = TT.run(_port_cfg(root, tmp_path / "whole", 4))
    handlers = {}
    monkeypatch.setattr(_signal, "signal", lambda sig, h: handlers.setdefault(sig, h))
    orig_write = TT.MetricsWriter.write

    def write_then_signal(self, step, scalars, prefix="train"):
        orig_write(self, step, scalars, prefix)
        if step == 2:
            handlers[_signal.SIGTERM](_signal.SIGTERM, None)

    monkeypatch.setattr(TT.MetricsWriter, "write", write_then_signal)
    cut = _port_cfg(root, tmp_path / "cut", 4, checkpoint_every=10)
    assert TT.run(cut)["step"] == 2
    assert CheckpointManager(os.path.join(cut.results_dir, "checkpoints")).all_steps() == [2]
    monkeypatch.setattr(TT.MetricsWriter, "write", orig_write)
    resumed = TT.run(cut)
    assert resumed["step"] == whole["step"] == 4
    assert resumed["opt"]["count"] == 4
    assert all(torch.equal(a, b) for a, b in zip(_leaves(resumed), _leaves(whole)))
    ref, got = _rows(tmp_path / "whole"), _rows(cut.results_dir)
    assert [r["step"] for r in got] == [1, 2, 3, 4]
    for a, b in zip(ref[2:], got[2:]):
        assert {k: v for k, v in a.items() if k not in TIMING} == \
            {k: v for k, v in b.items() if k not in TIMING}


def test_checkpoint_restores_to_the_templates_device_and_dtypes(tmp_path):
    """``restore`` casts to the template (an fp32 mu into a bf16 mu), keeps
    ``max_to_keep`` steps, skips a step saved already, and refuses a
    template of another layout."""
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"mu": {"w": torch.ones(2, 3)}, "nu": {"w": torch.zeros(2, 3)},
                     "count": 5}, "step": 5}
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        assert mgr.save(step, state)
        state["params"]["w"] += 1  # a later step updates the state in place
    assert not mgr.save(3, state)
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    template = {"params": {"w": torch.zeros(2, 3)},
                "opt": {"mu": {"w": torch.zeros(2, 3, dtype=torch.bfloat16)},
                        "nu": {"w": torch.zeros(2, 3)}, "count": 0}, "step": 0}
    got = mgr.restore(template=template)
    assert torch.equal(got["params"]["w"], torch.arange(6.0).reshape(2, 3) + 2)
    assert got["opt"]["mu"]["w"].dtype == torch.bfloat16
    assert got["opt"]["count"] == 5 and got["step"] == 5
    assert torch.equal(mgr.restore(2)["params"]["w"], torch.arange(6.0).reshape(2, 3) + 1)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(template={**template, "params": {"w": torch.zeros(3, 2)}})
    assert CheckpointManager(str(tmp_path / "empty")).restore() is None


def test_curriculum_switches_the_loss_range(root, tmp_path, monkeypatch):
    """Steps after ``loss_switch_step`` run the step built with the final
    ``max_val``; a half-configured or unreachable curriculum raises."""
    made = []
    orig = TL.make_train_step

    def spy(model_cfg, tcfg, device="cuda"):
        step = orig(model_cfg, tcfg, device)

        def run_step(state, batch, **kw):
            made.append((state["step"], tcfg.loss.max_val))
            return step(state, batch, **kw)
        return run_step

    monkeypatch.setattr(TL, "make_train_step", spy)
    TT.run(_port_cfg(root, tmp_path / "r", 3, loss_switch_step=1, loss_max_val_final=25.0))
    assert made == [(0, 30.0), (1, 25.0), (2, 25.0)]
    rows = _rows(tmp_path / "r")
    assert rows[0]["loss"] != rows[1]["loss"]
    for kw in (dict(loss_switch_step=1), dict(loss_max_val_final=25.0),
               dict(loss_switch_step=3, loss_max_val_final=25.0)):
        with pytest.raises(ValueError, match="curriculum"):
            TT.run(_port_cfg(root, tmp_path / "bad", 3, **kw))


def test_init_params_from_across_resolutions(root, tmp_path):
    """Params seeded from a 28 px checkpoint into a 42 px run: the ViT pos
    embed resampled from the 2 x 2 to the 3 x 3 grid, ``camera_head`` drawn
    afresh, everything else carried over, a fresh optimizer and step."""
    src = TT.run(_port_cfg(root, tmp_path / "p28", 1, checkpoint_every=1))
    seeded = TT.run(_port_cfg(
        root, tmp_path / "p42", 1, img_size=42,
        init_params_from=str(tmp_path / "p28" / "checkpoints"),
        reinit_subtrees="camera_head"))
    pe = src["params"]["aggregator"]["vit"]["pos_embed"]
    got = seeded["params"]["aggregator"]["vit"]["pos_embed"]
    assert got.shape == (1, 1 + 9, 64)
    assert torch.equal(got, resample_pos_embed(pe, 3))
    # warmup: the one step ran at learning rate 0 and moved nothing
    assert seeded["step"] == 1 and seeded["opt"]["count"] == 1
    same = TL._flatten({k: v for k, v in src["params"]["aggregator"].items() if k != "vit"})
    assert all(torch.equal(a, b) for a, b in zip(same, TL._flatten(
        {k: v for k, v in seeded["params"]["aggregator"].items() if k != "vit"})))
    cam_a, cam_b = (TL._flatten(s["params"]["camera_head"]) for s in (src, seeded))
    assert any(not torch.equal(a, b) for a, b in zip(cam_a, cam_b))
    with pytest.raises(ValueError, match="reinit-subtrees"):
        TT.run(_port_cfg(root, tmp_path / "bad", 1,
                         init_params_from=str(tmp_path / "p28" / "checkpoints"),
                         reinit_subtrees="no_such_head"))
    with pytest.raises(FileNotFoundError):
        TT.run(_port_cfg(root, tmp_path / "bad2", 1, init_params_from=str(tmp_path / "x")))


def test_early_stop_keeps_the_best_checkpoint(root, tmp_path):
    """Validation every step, patience 1 and a required gain of 100%: the
    second validation cannot improve, so the run stops at step 2 and the
    best checkpoint is step 1's."""
    cfg = _port_cfg(root, tmp_path, 5, eval_every=1, eval_data_root=root,
                    early_stop_patience=1, eval_min_delta=1.0, checkpoint_every=10, **EVAL)
    state = TT.run(cfg)
    assert state["step"] == 2
    with open(tmp_path / "best.json") as f:
        assert json.load(f)["best_step"] == 1
    assert CheckpointManager(str(tmp_path / "checkpoints_best")).all_steps() == [1]
    assert CheckpointManager(str(tmp_path / "checkpoints")).all_steps() == [2]
    assert [r["step"] for r in _rows(tmp_path, "val")] == [1, 2]


def test_artifacts_sanity_and_profile_are_written(root, tmp_path):
    cfg = _port_cfg(root, tmp_path, 2, artifact_every=2, sanity_check_every=1,
                    profile_start=0, profile_steps=1)
    TT.run(cfg)
    out = tmp_path / "vls" / "step_2"
    for name in ("pred.ply", "poses_kitti.txt", "cdf_pdf_exact.png", "cdf_pdf_approx.png",
                 "sanity_overlay.png", "reproj_grid.png"):
        assert os.path.getsize(out / name) > 0, name
    sanity = _rows(tmp_path, "sanity")
    assert [r["step"] for r in sanity] == [1, 2]
    assert all(np.isfinite(r["mean_px_offset"]) for r in sanity)
    assert os.path.getsize(tmp_path / "profile" / "trace.json") > 0


def test_dataset_object_in_place_of_the_data_root(root, tmp_path):
    """Any object with ``__len__`` and ``load_scene`` stands in for the
    directory, for training and for validation: the same run."""
    from self_supervise_sfm_tpu_torch.data.imc2021 import IMC2021Scenes

    a = TT.run(_port_cfg(root, tmp_path / "a", 2))
    ds = IMC2021Scenes(root, sample_num=64, num_images=S, target_size=IMG, use_native=False)
    b = TT.run(_port_cfg(ds, tmp_path / "b", 2, eval_every=2, eval_data_root=ds, **EVAL))
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert len(_rows(tmp_path / "b", "val")) == 1


def test_command_line(root, tmp_path):
    TT.main(["--data-root", root, "--results-dir", str(tmp_path), "--device", "cpu",
             "--steps", "1", "--img-size", str(IMG), "--num-images", str(S),
             "--sample-num", "32", "--embed-dim", "64", "--depth", "4", "--num-heads", "4",
             "--vit-depth", "2", "--rank", str(RANK), "--compute-dtype", "float32",
             "--checkpoint-every", "1", "--artifact-every", "0", "--sanity-check-every",
             "0", "--no-native-loader", "--adam-mu-dtype", "bfloat16"])
    state = CheckpointManager(str(tmp_path / "checkpoints")).restore()
    assert state["step"] == 1
    assert TL._flatten(state["opt"]["mu"])[0].dtype == torch.bfloat16


def test_pretrained_run_matches_jax(root, jax_run, tmp_path):
    """``--pretrained``: JAX's starting params written as a reference
    SAIL-Recon state dict (in a ``state_dict`` wrapper), loaded and
    converted by the port's trainer, then stepped with JAX's subsample:
    the JAX run's losses and metrics, as the resumed run above."""
    from tests.test_torch_converter import reference_state_dict

    sd = reference_state_dict(jax_run["state0"]["params"])
    path = tmp_path / "sailrecon.pt"
    torch.save({"state_dict": {k: torch.from_numpy(v.copy()) for k, v in sd.items()}}, path)
    idx = [torch.from_numpy(i) for i in jax_run["idx"]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TT, "step_subsample",
                   lambda seed, step, device: {"subsample_indices": idx[step]})
        TT.run(_port_cfg(root, tmp_path / "run", STEPS, pretrained=str(path)))
    rows = _rows(tmp_path / "run")
    assert [r["step"] for r in rows] == [r["step"] for r in jax_run["train"]]
    for ref, got in zip(jax_run["train"], rows):
        for k in ("loss", "loss_cdf_exact", "loss_cdf_approx"):
            assert got[k] == pytest.approx(ref[k], abs=1e-5), k
        for k in set(ref) - TIMING - {"step", "prefix", "loss", "loss_cdf_exact",
                                      "loss_cdf_approx"}:
            assert got[k] == pytest.approx(ref[k], rel=2e-4, abs=1e-12), k


@pytest.mark.parametrize("kw,what", [
    (dict(num_context=2), "multi-device"),
    (dict(num_model=2), "multi-device"),
    (dict(num_context=3, train=TL.TrainConfig(fsdp=True)), "multi-device"),
])
def test_unported_options_raise(root, tmp_path, kw, what):
    """In one process without a process group a context or model extent
    above 1 needs ranks that are not there (ValueError naming torchrun;
    tensor parallelism runs under it, ``tests/test_torch_tp_trainer.py``).
    ``fsdp`` alone runs, unsharded, as JAX's does at a data extent of 1
    (``tests/test_torch_trainer_sharded.py``)."""
    with pytest.raises(ValueError, match=what) as err:
        TT.run(_port_cfg(root, tmp_path, 1, **kw))
    assert "torchrun" in str(err.value)


def test_default_device_raises_without_a_card(root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = replace(_port_cfg(root, tmp_path, 1), device=TT.TrainerConfig().device)
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.run(cfg)


def test_step_subsample_depends_on_seed_and_step_alone():
    from self_supervise_sfm_tpu_torch.models import aggregator as TA
    from self_supervise_sfm_tpu_torch.models import sailrecon as TM

    acfg = TM.make_config(**TINY).aggregator

    def draw(seed, step):
        g = TT.step_subsample(seed, step, "cpu")["generator"]
        return TA.draw_subsample_indices(acfg, 1, S, P0, RANK, g)

    assert torch.equal(draw(0, 5), draw(0, 5))
    assert not torch.equal(draw(0, 5), draw(0, 6))
    assert not torch.equal(draw(0, 5), draw(1, 5))
