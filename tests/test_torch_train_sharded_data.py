"""PyTorch port: the sharded train step over ``data`` alone (2 gloo ranks,
one scene each) vs the JAX package's single-device step and its step under
the same mesh: DDP, and FSDP on a process-local batch; two steps at
``tests/test_torch_train_step.py``'s tolerances (see
``tests/_torch_train_sharded.py``)."""

import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu_torch.train import loop as TL
from tests import _torch_train_sharded as TS

torch.set_num_threads(1)

MESH = (2, 1)
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
             TS.train_case("fsdp", MESH, True, process_local=True)]
    return TS.port_ranks(tmp_path_factory.mktemp("train_2x1"), batch, jax_ref, cases, 2)


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


@pytest.mark.parametrize("case", CASES)
def test_every_rank_holds_the_same_metrics_and_params(ranks, case):
    first, other = ranks[case]
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
