"""PyTorch port: the train step with tensor parallelism over ``model`` alone
(gloo ranks, DDP x TP at (data, context, model) = (1, 1, 2) and (1, 1, 4):
one head and a quarter of the MLP's hidden units a rank at the second) vs
the JAX package's single-device step and its step under the same mesh
(JAX's ``tests/test_tp.py`` pattern: ``param_sharding(tp=True)``
placements), and a model whose blocks do not all divide the model extent.

Every block of the aggregator runs Megatron's body on the rank's head and
hidden shard, held at rest; after the backward the leaves read inside a
column-parallel branch (LN1, the qk-norms, LN2) are summed over ``model``
and no other. At (1, 1, 2) the aggregator's layers are rematerialised (the
recompute in the backward reruns Megatron's blocks). Two steps (the first
at learning rate 0), at ``tests/test_torch_train_step.py``'s tolerances
(see ``tests/_torch_train_sharded.py``); every rank reports the same
metrics, and each rank holds 1/m of every leaf that Megatron cuts and the
whole of the others.

The mixed model runs a ViT of 2 heads (which do not split over 4 ranks)
beside an aggregator of 4 (which do): the port decides tensor parallelism
once for the whole model (``sp_block.tp_engaged``), so the state stays
whole on every rank and every block runs whole on each model rank (JAX
falls back block by block, with the same result). Its steps are held to
the port's one-device steps of the same model (a mesh of one rank), at
the same tolerances.
"""

import pytest
import torch

from tests import _torch_train_sharded as TS
from tests._torch_tp_train import check_every_rank_alike, check_tp_slices

torch.set_num_threads(1)

# case -> (data, context, model)
CASES = {"ddp_tp": (1, 1, 2), "ddp_tp4": (1, 1, 4)}
MIXED = {**TS.KW, **TS.PORT_ROUTE, "vit_num_heads": 2}


@pytest.fixture(scope="module")
def batch():
    return TS.make_batch()


@pytest.fixture(scope="module")
def jax_ref(batch):
    return TS.jax_runs(batch, list(CASES.values()))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, batch, jax_ref):
    case = TS.train_case("ddp_tp", CASES["ddp_tp"], False)
    # each layer rematerialised: its recompute in the backward runs
    # Megatron's body again, outside the forward's contexts
    case["config"] = {**case["config"], "remat": True}
    cases = [case, TS.train_case("ddp_tp4", CASES["ddp_tp4"], False)]
    for name, mesh in (("mixed", (1, 1, 4)), ("mixed_one", (1, 1, 1))):
        cases.append({**TS.train_case(name, mesh, False), "config": MIXED})
    return TS.port_ranks(tmp_path_factory.mktemp("train_tp_ddp"), batch, jax_ref, cases, 4)


@pytest.mark.parametrize("ref", ["single", "mesh"])
@pytest.mark.parametrize("step", range(TS.STEPS))
@pytest.mark.parametrize("case", CASES)
def test_loss_and_metrics_match_jax(ranks, jax_ref, case, step, ref):
    want = jax_ref["single" if ref == "single" else CASES[case]]["metrics"][step]
    TS.check_metrics(ranks[case][0][f"metrics{step}"], want, step)


@pytest.mark.parametrize("ref", ["single", "mesh"])
@pytest.mark.parametrize("step", range(TS.STEPS))
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax(ranks, jax_ref, case, step, ref):
    want = jax_ref["single" if ref == "single" else CASES[case]]["grads"][step]
    TS.check_grads(ranks[case][0][f"grads{step}"], want)


@pytest.mark.parametrize("ref", ["single", "mesh"])
@pytest.mark.parametrize("case", CASES)
def test_new_params_match_jax(ranks, jax_ref, case, ref):
    run = jax_ref["single" if ref == "single" else CASES[case]]
    for step in range(TS.STEPS):
        TS.check_params(ranks[case][0][f"params{step}"], run["params"][step])


@pytest.mark.parametrize("case", CASES)
def test_every_rank_holds_the_same_metrics_and_params(ranks, case):
    check_every_rank_alike(ranks[case])


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_slice(ranks, case):
    check_tp_slices(ranks[case], CASES[case], False)


@pytest.mark.parametrize("step", range(TS.STEPS))
def test_mixed_divisibility_matches_one_device(ranks, step):
    """Loss, metrics and every leaf's gradient of each model rank against the
    one-device step: no block ran Megatron's body on whole weights."""
    one = ranks["mixed_one"][0]
    for r in ranks["mixed"]:
        TS.check_metrics(r[f"metrics{step}"], one[f"metrics{step}"], step)
        TS.check_grads(r[f"grads{step}"], one[f"grads{step}"])


def test_mixed_divisibility_params_match_one_device(ranks):
    one = ranks["mixed_one"][0]
    for r in ranks["mixed"]:
        for step in range(TS.STEPS):
            TS.check_params(r[f"params{step}"], one[f"params{step}"])


def test_mixed_divisibility_keeps_whole_leaves(ranks):
    """The layout is not tensor-parallel: every rank holds every leaf whole."""
    TS.check_slices(ranks["mixed"], 1, False)
