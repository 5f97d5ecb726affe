"""PyTorch port: the train step with tensor parallelism composed with FSDP
(4 gloo ranks, FSDP x TP at (data, context, model) = (2, 1, 2)) vs the JAX
package's single-device step and its step under the same mesh (JAX's
``tests/test_tp.py`` pattern: ``param_sharding(tp=True)`` placements).

Scenes over ``data`` (each data rank handed its own, a process-local batch)
and every block of the aggregator on Megatron's body; FSDP's cut applies to
each rank's model part (the trunk cast and gathered over ``data`` into the
model-local whole, the gradients reduce-scattered back), and the leaves
read inside a column-parallel branch are summed over ``model`` as well.
Two steps (the first at learning rate 0), at
``tests/test_torch_train_step.py``'s tolerances (see
``tests/_torch_train_sharded.py``); every rank reports the same metrics,
and each rank holds its model part of the leaves that Megatron cuts, then
half of each leaf FSDP cuts.
"""

import pytest
import torch

from tests import _torch_train_sharded as TS
from tests._torch_tp_train import check_every_rank_alike, check_tp_slices

torch.set_num_threads(1)

MESH = (2, 1, 2)
CASES = {"fsdp_tp": True}


@pytest.fixture(scope="module")
def batch():
    return TS.make_batch()


@pytest.fixture(scope="module")
def jax_ref(batch):
    return TS.jax_runs(batch, [MESH])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, batch, jax_ref):
    cases = [TS.train_case("fsdp_tp", MESH, True, process_local=True)]
    return TS.port_ranks(tmp_path_factory.mktemp("train_tp_2x1x2"), batch, jax_ref, cases, 4)


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
    check_every_rank_alike(ranks[case])


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_slice(ranks, case):
    check_tp_slices(ranks[case], MESH, CASES[case])
