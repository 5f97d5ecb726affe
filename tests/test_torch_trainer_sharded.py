"""PyTorch port: the trainer under a mesh of 2 gloo ranks with FSDP against
the port's one-device trainer, and checkpoints that resume across meshes.

A tiny model of width 128 (JAX's ``tests/_trainer_mh_worker.py`` sizes it
so that FSDP cuts its MLP leaves), 2 synthetic scenes, 2 steps with a
checkpoint after each, a sanity check (the diagnostics forward: every rank
enters the gathers, rank 0 runs it) and a validation at step 2. The mesh
run (one scene a rank, ``scenes_per_step_per_device=1``) and the
one-device run (both scenes in one batch) see the same global batch and
subsample, so they agree at JAX's ``tests/test_trainer.py`` tolerance for
the multi-process trainer (params rtol 1e-5 / atol 1e-6, element by
element; losses atol 1e-5). Each rank loads only its own scene slot; only rank 0 writes
metrics. Checkpoints: one saved under 2 ranks restores bit-equal into the
one-device trainer's state and one saved on one device restores bit-equal
under 2 ranks (each rank keeps its slices); a run resumed on the mesh it
was saved on is bit-equal to the uninterrupted run, and a run resumed on
the other mesh agrees with it at the trainer tolerance.
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
# the CDF's range wide enough that the random model's residuals are inside it
LOSS = dict(num_bins=50, max_val=30.0)
# the DPT heads narrowed: at their default widths they are 55 M of the tiny
# model's 61 M parameters, and the module writes a dozen checkpoints
DPT = dict(features=16, out_channels=[16, 32, 64, 64])


def _trainer(root, results, spd, steps=STEPS, checkpoint_every=1):
    return dict(data_root=str(root), results_dir=str(results), total_steps=steps,
                num_images=2, sample_num=64, scenes_per_step_per_device=spd, seed=SEED,
                checkpoint_every=checkpoint_every, artifact_every=0, sanity_check_every=2,
                eval_every=2, eval_data_root=str(root), eval_num_images=2, eval_sample_num=64,
                log_every=1, native_loader=False, device="cpu", **MODEL)


def _run_one_device(root, results, fsdp=False, checkpoint_every=1):
    train = TL.TrainConfig(**TRAIN, loss=LossConfig(**LOSS), fsdp=fsdp)
    cfg = TT.TrainerConfig(**_trainer(root, results, 2, checkpoint_every=checkpoint_every),
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
    tmp = tmp_path_factory.mktemp("trainer_sharded")
    root = tmp / "data"
    make_synthetic_dataset(str(root), num_scenes=2, num_images=3, image_size=(40, 32))
    # the one-device runs: plain, with fsdp (no mesh: unsharded, as JAX's)
    out = {"root": root, "tmp": tmp}
    out["B"] = _run_one_device(root, tmp / "B")
    out["B_fsdp"] = _run_one_device(root, tmp / "B_fsdp", fsdp=True, checkpoint_every=0)
    _copy_step(tmp / "B", tmp / "C", 1)
    train = dict(train={**TRAIN, "fsdp": True}, loss=LOSS, dpt=DPT)
    cases = [
        dict(name="A", trainer=_trainer(root, tmp / "A", 1), **train),
        dict(name="A2", trainer=_trainer(root, tmp / "A2", 1, checkpoint_every=0),
             copy_from=[[str(tmp / "A"), 1]], **train),
        dict(name="C1", trainer=_trainer(root, tmp / "C", 1, steps=1, checkpoint_every=0),
             **{**train, "train": {**TRAIN, "total_steps": 1, "fsdp": True}}),
        dict(name="C2", trainer=_trainer(root, tmp / "C", 1, checkpoint_every=0), **train),
    ]
    for case in cases:
        case.update(kind="trainer", mesh=[WORLD, 1, 1])
        save_tree(tmp / f"{case['name']}.in.npz", {})
    launch(dict(cases=cases), WORLD, tmp, timeout=300)
    for case in cases:
        out[case["name"]] = [load_tree(tmp / f"{case['name']}.r{r}.npz") for r in range(WORLD)]
    # a checkpoint of the mesh resumed on one device
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
    by element. JAX holds each leaf's sum to it, between two runs of one
    program; here the two programs differ (a batch of 2 scenes against 2
    ranks of 1), and a sum of n elements adds up n such differences."""
    la, lb = TL._flatten(a), TL._flatten(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x.double().numpy(), y.double().numpy(), rtol=1e-5, atol=1e-6)


def test_fsdp_trainer_matches_the_one_device_trainer(run):
    assert int(run["A"][0]["step"]) == STEPS
    _assert_close(run["A"][0]["state"]["params"], run["B"]["params"])
    for a, b in zip(_rows(run["tmp"] / "A"), _rows(run["tmp"] / "B")):
        assert a["step"] == b["step"]
        assert abs(a["loss"] - b["loss"]) <= 1e-5
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=2e-4)


def test_the_mesh_run_cut_its_state(run):
    """FSDP was in effect: each rank held half of every cut leaf."""
    for r in run["A"]:
        assert bool(r["fsdp"])
    whole = [t.numel() for t in TL._flatten(run["B"]["params"])]
    got = [int(n) for n in TL._flatten(run["A"][0]["numel"])]
    assert sum(got) < sum(whole) and any(g * 2 == w for g, w in zip(got, whole))


def test_each_rank_loaded_only_its_scenes(run):
    """Rank r's loads come from slot r's stream, (seed, step, r), step by
    step; the other slot's never."""
    def fingerprint(step, slot):
        rng = np.random.default_rng(np.random.SeedSequence((SEED, step, slot)))
        rng.integers(2)
        return rng.random()

    for r, res in enumerate(run["A"]):
        seen = res["seen"].numpy()
        assert len(seen) >= STEPS
        assert list(seen[:STEPS]) == [fingerprint(t, r) for t in range(STEPS)]
        others = {fingerprint(t, 1 - r) for t in range(len(seen))}
        assert not others & set(seen.tolist())


def test_only_rank_zero_wrote_metrics(run):
    rows = _rows(run["tmp"] / "A")
    assert [r["step"] for r in rows] == list(range(1, STEPS + 1))
    assert len(_rows(run["tmp"] / "A", "sanity")) == 1
    assert len(_rows(run["tmp"] / "A", "val")) == 1


def test_diagnostics_and_validation_under_the_mesh(run):
    """Rank 0's sanity check ran on the gathered params (its pair is drawn
    afresh each time, so its offset is only finite), and every rank's
    validation agrees with the one-device trainer's."""
    (sanity,) = _rows(run["tmp"] / "A", "sanity")
    assert np.isfinite(sanity["mean_px_offset"])
    for key in ("px_residual", "log_residual"):
        (a,), (b,) = _rows(run["tmp"] / "A", "val"), _rows(run["tmp"] / "B", "val")
        assert np.isfinite(a[key]) and a[key] == pytest.approx(b[key], rel=2e-4), key


def test_saved_under_two_ranks_restores_on_one(run):
    """The mesh's step-2 checkpoint, restored into the one-device trainer's
    state, is the mesh's final state bit for bit; the one-device run
    resumed from its step-1 checkpoint agrees with the mesh run."""
    back = CK.CheckpointManager(str(run["tmp"] / "A" / "checkpoints")).restore(
        STEPS, template=run["B"])
    _assert_bit_equal(_whole(back), run["A"][0]["state"])
    assert back["step"] == back["opt"]["count"] == STEPS
    _assert_close(run["D"]["params"], run["A"][0]["state"]["params"])


def test_saved_on_one_device_restores_under_two_ranks(run):
    """The one-device step-1 checkpoint restored under 2 ranks (each keeping
    its slices, gathered here) is bit-equal to what was saved; the resumed
    mesh run agrees with the one-device run."""
    saved = CK.CheckpointManager(str(run["tmp"] / "B" / "checkpoints")).restore(1)
    assert [int(r["step"]) for r in run["C1"]] == [1, 1]
    _assert_bit_equal(run["C1"][0]["state"], _whole(saved))
    assert int(run["C2"][0]["step"]) == STEPS
    _assert_close(run["C2"][0]["state"]["params"], run["B"]["params"])


def test_resume_on_the_same_mesh_is_bit_equal(run):
    _assert_bit_equal(run["A2"][0]["state"], run["A"][0]["state"])
    ra, rb = _rows(run["tmp"] / "A2"), _rows(run["tmp"] / "A")
    assert [r["step"] for r in ra] == [STEPS]
    assert ra[0]["loss"] == rb[-1]["loss"] and ra[0]["grad_norm"] == rb[-1]["grad_norm"]


def test_fsdp_without_a_mesh_runs_unsharded(run):
    """``fsdp`` in one process is JAX's behaviour at a data extent of 1: no
    cut, the plain run bit for bit."""
    _assert_bit_equal(_whole(run["B_fsdp"]), _whole(run["B"]))
