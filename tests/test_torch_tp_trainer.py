"""PyTorch port: the trainer with tensor parallelism (``num_model=2``, the
JAX CLI's ``--tp``) on 2 gloo ranks against the port's one-device trainer,
and checkpoints that move between the two.

``tests/test_torch_trainer_sharded.py``'s tiny model of width 128 (4 heads,
hidden 512: both split over 2 model ranks), 2 synthetic scenes, 2 steps
with a checkpoint after each, a sanity check (the diagnostics forward on
the params gathered over ``model``) and a validation at step 2. Both model
ranks load both scenes (a data extent of 1) and hold their head and hidden
parts of every aggregator block, so the run agrees with the one-device run
at JAX's multi-process trainer tolerance (params rtol 1e-5 / atol 1e-6,
losses atol 1e-5). Checkpoints hold the whole state: the TP run's step-2
checkpoint restores bit-equal into the one-device state, the one-device
step-1 checkpoint restores bit-equal under TP (each rank keeping its
parts), and a one-device run resumed from the TP run's step-1 checkpoint
agrees with it.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.data.synthetic import make_synthetic_dataset
from self_supervise_sfm_tpu_torch.train import checkpoint as CK
from self_supervise_sfm_tpu_torch.train import loop as TL
from self_supervise_sfm_tpu_torch.train import trainer as TT
from self_supervise_sfm_tpu_torch.train.loss import LossConfig
from tests._torch_dist_worker import launch, load_tree, narrow_dpt_heads, save_tree

torch.set_num_threads(1)

STEPS, SEED, WORLD = 2, 0, 2
MODEL = dict(img_size=28, embed_dim=128, depth=4, num_heads=4, vit_depth=2, rank=2,
             compute_dtype="float32", remat=False)
TRAIN = dict(max_lr=1e-4, warmup_steps=1, total_steps=STEPS, rank=2, num_images=2)
LOSS = dict(num_bins=50, max_val=30.0)
DPT = dict(features=16, out_channels=[16, 32, 64, 64])


def _trainer(root, results, steps=STEPS, checkpoint_every=1, num_model=1):
    return dict(data_root=str(root), results_dir=str(results), total_steps=steps,
                num_images=2, sample_num=64, scenes_per_step_per_device=2, seed=SEED,
                checkpoint_every=checkpoint_every, artifact_every=0, sanity_check_every=2,
                eval_every=2, eval_data_root=str(root), eval_num_images=2, eval_sample_num=64,
                log_every=1, native_loader=False, device="cpu", num_model=num_model,
                **MODEL)


def _run_one_device(root, results, checkpoint_every=1):
    train = TL.TrainConfig(**TRAIN, loss=LossConfig(**LOSS))
    cfg = TT.TrainerConfig(**_trainer(root, results, checkpoint_every=checkpoint_every),
                           train=train)
    model_config = TT._model_config
    TT._model_config = lambda c: narrow_dpt_heads(model_config(c), DPT)
    try:
        return TT.run(cfg)
    finally:
        TT._model_config = model_config


def _copy_step(src, dst, step):
    shutil.copytree(os.path.join(src, "checkpoints", str(step)),
                    os.path.join(dst, "checkpoints", str(step)))


def _rows(results, prefix="train"):
    import json

    with open(os.path.join(results, "tensorboard", "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["prefix"] == prefix]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_tp")
    root = tmp / "data"
    make_synthetic_dataset(str(root), num_scenes=2, num_images=3, image_size=(40, 32))
    out = {"root": root, "tmp": tmp}
    out["B"] = _run_one_device(root, tmp / "B")
    _copy_step(tmp / "B", tmp / "C", 1)
    train = dict(train=TRAIN, loss=LOSS, dpt=DPT)
    cases = [
        dict(name="A", trainer=_trainer(root, tmp / "A", num_model=WORLD), **train),
        dict(name="C1", trainer=_trainer(root, tmp / "C", steps=1, checkpoint_every=0,
                                         num_model=WORLD),
             **{**train, "train": {**TRAIN, "total_steps": 1}}),
    ]
    for case in cases:
        case.update(kind="trainer", mesh=[1, 1, WORLD])
        save_tree(tmp / f"{case['name']}.in.npz", {})
    launch(dict(cases=cases), WORLD, tmp, timeout=300)
    for case in cases:
        out[case["name"]] = [load_tree(tmp / f"{case['name']}.r{r}.npz") for r in range(WORLD)]
    _copy_step(tmp / "A", tmp / "D", 1)
    out["D"] = _run_one_device(root, tmp / "D", checkpoint_every=0)
    return out


def _whole(state):
    return {"params": state["params"], "mu": state["opt"]["mu"], "nu": state["opt"]["nu"]}


def _assert_bit_equal(a, b):
    la, lb = TL._flatten(a), TL._flatten(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert torch.equal(x.float(), y.float())


def _assert_close(a, b):
    """JAX's multi-process trainer tolerance (rtol 1e-5, atol 1e-6), element
    by element."""
    la, lb = TL._flatten(a), TL._flatten(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x.double().numpy(), y.double().numpy(), rtol=1e-5, atol=1e-6)


def test_tp_trainer_matches_the_one_device_trainer(run):
    assert [int(r["step"]) for r in run["A"]] == [STEPS, STEPS]
    _assert_close(run["A"][0]["state"]["params"], run["B"]["params"])
    rows_a, rows_b = _rows(run["tmp"] / "A"), _rows(run["tmp"] / "B")
    assert [r["step"] for r in rows_a] == [r["step"] for r in rows_b] == [1, 2]
    for a, b in zip(rows_a, rows_b):
        assert abs(a["loss"] - b["loss"]) <= 1e-5
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=2e-4)


def test_the_tp_run_cut_its_state(run):
    """Megatron's cut was in effect: each rank held half of qkv, proj, fc1
    and fc2 of every aggregator block, and the heads whole."""
    whole = run["B"]["params"]
    for r in run["A"]:
        numel = r["numel"]
        blk = numel["aggregator"]["frame_blocks"][0]
        ref = whole["aggregator"]["frame_blocks"][0]
        for path in (("attn", "qkv", "w"), ("attn", "proj", "w"), ("mlp", "fc1", "w"),
                     ("mlp", "fc2", "w"), ("mlp", "fc1", "b")):
            a, b = blk, ref
            for k in path:
                a, b = a[k], b[k]
            assert int(a) * WORLD == b.numel(), path
        assert int(blk["attn"]["proj"]["b"]) == ref["attn"]["proj"]["b"].numel()
        cam = [int(n) for n in TL._flatten(numel["camera_head"])]
        assert cam == [t.numel() for t in TL._flatten(whole["camera_head"])]


def test_diagnostics_and_validation_under_tp(run):
    (sanity,) = _rows(run["tmp"] / "A", "sanity")
    assert np.isfinite(sanity["mean_px_offset"])
    (a,), (b,) = _rows(run["tmp"] / "A", "val"), _rows(run["tmp"] / "B", "val")
    for key in ("px_residual", "log_residual"):
        assert np.isfinite(a[key]) and a[key] == pytest.approx(b[key], rel=2e-4), key


def test_tp_checkpoint_restores_at_world_one(run):
    """The TP run's step-2 checkpoint, restored into the one-device state,
    is the TP run's final state (gathered over ``model``) bit for bit; the
    one-device run resumed from its step-1 checkpoint agrees with it."""
    back = CK.CheckpointManager(str(run["tmp"] / "A" / "checkpoints")).restore(
        STEPS, template=run["B"])
    _assert_bit_equal(_whole(back), run["A"][0]["state"])
    assert back["step"] == back["opt"]["count"] == STEPS
    _assert_close(run["D"]["params"], run["A"][0]["state"]["params"])


def test_one_device_checkpoint_resumes_under_tp(run):
    """The one-device step-1 checkpoint restored under TP (each rank keeping
    its parts, gathered here) is bit-equal to what was saved."""
    saved = CK.CheckpointManager(str(run["tmp"] / "B" / "checkpoints")).restore(1)
    assert [int(r["step"]) for r in run["C1"]] == [1, 1]
    _assert_bit_equal(run["C1"][0]["state"], _whole(saved))
