"""Checks shared by ``tests/test_torch_tp_train_*.py``: the ranks of a
tensor-parallel train step agree, and each holds its part of the state."""

import numpy as np
import torch

from self_supervise_sfm_tpu_torch.parallel import sharding as Sh
from self_supervise_sfm_tpu_torch.train import loop as TL
from tests import _torch_train_sharded as TS


def check_every_rank_alike(ranks):
    """The metrics are computed alike on every rank (the gathered poses, the
    norms' all-reduces over ``data`` and ``model``); the gathered params
    agree bit for bit."""
    first = ranks[0]
    for other in ranks[1:]:
        for step in range(TS.STEPS):
            a, b = first[f"metrics{step}"], other[f"metrics{step}"]
            assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
            for x, y in zip(TL._flatten(first[f"params{step}"]),
                            TL._flatten(other[f"params{step}"])):
                assert torch.equal(x, y)
        np.testing.assert_array_equal(other["count"].numpy(), [TS.STEPS, TS.STEPS])


def check_tp_slices(ranks, mesh, fsdp):
    """Each rank's leaf sizes of params, mu and nu: Megatron's parts (1/m of
    the aggregator's block leaves that it cuts; the heads and tokens whole),
    then FSDP's 1/n of the leaves it cuts; the bytes as
    ``loop.state_bytes_per_rank`` counts them."""
    nd, _, nm = mesh
    cfg = TS.port_config()
    shapes = TL.param_shapes(cfg)
    ext = {"data": nd, "model": nm}
    specs = TL.layout_specs(ext, shapes, fsdp and nd > 1, True)
    for r in ranks:
        assert bool(r["fsdp"]) == (fsdp and nd > 1)
        for key in ("params", "mu", "nu"):
            tree = r["numel"][key]
            got = np.array([int(n) for n in TL._flatten(tree)])
            want = np.array([int(np.prod(Sh.local_shape(t.shape, s, ext))) for t, s in zip(
                Sh.leaves_like(tree, shapes), Sh.leaves_like(tree, specs))])
            model_cut = np.array(["model" in s for s in Sh.leaves_like(tree, specs)])
            assert model_cut.any()
            np.testing.assert_array_equal(got, want, err_msg=key)
            assert int(got.sum()) * 12 == TL.state_bytes_per_rank(cfg, nd, fsdp, m=nm)
