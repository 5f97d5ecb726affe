"""PyTorch port: the sharded train step on 2 x 2 gloo ranks vs the JAX
package's single-device step and its step under the same mesh.

Scenes over ``data``, each scene's frames and global-attention tokens over
``context`` (the ring in the forward and the backward), gradients summed in
flat buckets (DDP) or the params and both Adam moments cut over ``data``
(FSDP: the trunk gathered once a step, gradients reduce-scattered back). The
FSDP case is handed each data rank's own scenes (a process-local batch, as
the trainer loads them). Two steps (the first at learning rate 0), at
``tests/test_torch_train_step.py``'s tolerances: the loss and its parts
atol 1e-5, the other metrics and every gradient rtol 2e-4 (gradients atol
1e-5), the new params atol 1e-6; every rank reports the same metrics and
each FSDP rank holds half of every cut leaf and of its moments. A clipped
FSDP step is held to the port's one-device clipped step, and a ``model``
extent of 2 gives a tensor-parallel layout (the TP steps themselves:
``tests/test_torch_tp_train_*.py``). See ``tests/_torch_train_sharded.py``.
"""

import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu_torch.train import loop as TL
from self_supervise_sfm_tpu_torch.train.loss import LossConfig as TLossConfig
from tests import _torch_train_sharded as TS

torch.set_num_threads(1)

MESH = (2, 2)
CLIP = 1.0
CASES = {"ddp": False, "fsdp": True}


@pytest.fixture(scope="module")
def batch():
    return TS.make_batch()


@pytest.fixture(scope="module")
def jax_ref(batch):
    return TS.jax_runs(batch, [MESH])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, batch, jax_ref):
    cases = [TS.train_case("ddp", MESH, False),
             TS.train_case("fsdp", MESH, True, process_local=True),
             TS.train_case("clip", MESH, True, grad_clip_norm=CLIP),
             dict(name="refusals", kind="train_model_extent", mesh=[1, 1, 2],
                  config={**TS.KW, **TS.PORT_ROUTE}, dpt_heads=False, train=TS.TRAIN,
                  loss=TS.LOSS)]
    return TS.port_ranks(tmp_path_factory.mktemp("train_2x2"), batch, jax_ref, cases, 4)


@pytest.mark.parametrize("ref", ["single", "mesh"])
@pytest.mark.parametrize("step", range(TS.STEPS))
@pytest.mark.parametrize("case", CASES)
def test_loss_and_metrics_match_jax(ranks, jax_ref, case, step, ref):
    want = jax_ref["single" if ref == "single" else MESH]["metrics"][step]
    TS.check_metrics(ranks[case][0][f"metrics{step}"], want, step)


@pytest.mark.parametrize("ref", ["single", "mesh"])
@pytest.mark.parametrize("step", range(TS.STEPS))
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax(ranks, jax_ref, case, step, ref):
    want = jax_ref["single" if ref == "single" else MESH]["grads"][step]
    TS.check_grads(ranks[case][0][f"grads{step}"], want)


@pytest.mark.parametrize("ref", ["single", "mesh"])
@pytest.mark.parametrize("case", CASES)
def test_new_params_match_jax(ranks, jax_ref, case, ref):
    run = jax_ref["single" if ref == "single" else MESH]
    for step in range(TS.STEPS):
        TS.check_params(ranks[case][0][f"params{step}"], run["params"][step])


@pytest.mark.parametrize("case", [*CASES, "clip"])
def test_every_rank_holds_the_same_metrics_and_params(ranks, case):
    """The metrics are computed alike from the gathered poses and the
    norms' all-reduce; the gathered params agree bit for bit."""
    first = ranks[case][0]
    for other in ranks[case][1:]:
        for step in range(TS.STEPS):
            a, b = first[f"metrics{step}"], other[f"metrics{step}"]
            assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
            for x, y in zip(TL._flatten(first[f"params{step}"]),
                            TL._flatten(other[f"params{step}"])):
                assert torch.equal(x, y)
        np.testing.assert_array_equal(other["count"].numpy(), [TS.STEPS, TS.STEPS])


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_slice(ranks, case):
    TS.check_slices(ranks[case], MESH[0], CASES[case])


def test_clipped_fsdp_step_matches_the_one_device_step(ranks, batch, jax_ref):
    """Clipping by the global norm of the reduced gradients (FSDP's slices
    summed over ``data``, whole leaves once) clips every rank alike and
    moves the params as the one-device step does."""
    cfg = TS.port_config()
    tcfg = TL.TrainConfig(**TS.TRAIN, loss=TLossConfig(**TS.LOSS), grad_clip_norm=CLIP)
    state = TL.train_state_from_params(TS.trained_params(jax_ref["state0"]["params"]), tcfg)
    step = TL.make_train_step(cfg, tcfg, "cpu")
    got = ranks["clip"][0]
    for i in range(TS.STEPS):
        state, m = step(state, batch, subsample_indices=torch.from_numpy(
            jax_ref["single"]["idx"][i]))
        assert float(m["grad_norm"]) > 10 * CLIP  # the clip is in effect
        TS.check_metrics(got[f"metrics{i}"], {k: float(v) for k, v in m.items()}, i)
        TS.check_params(got[f"params{i}"], state["params"])


def test_model_extent_is_refused(ranks):
    """A ``model`` extent of 2 is no longer refused: the step and the layout
    are made, the layout is tensor-parallel, and the step refuses a state of
    whole leaves (one made for another layout)."""
    for r in ranks["refusals"]:
        assert r["raised"].numpy().tolist() == [False, False]
        assert bool(r["tp"].item()) and bool(r["whole_refused"].item())
