"""PyTorch port: ``native/ba.py:ba_solve_multihost`` on 2 and 4 gloo ranks
vs the JAX package's ``ba_solve_distributed(num_shards=n)``.

Every rank is handed ``tests/_ba_mh_worker.py``'s problem and solves its
round-robin point partition; the reduced systems are summed over the
group in float64. The reference is the JAX package's one-process N-shard
solver on the port's library (``build/ba/``) with one OpenMP thread, as
the ranks run it: cameras and points atol 1e-6, the final cost rtol 1e-9
(``tests/test_native_ba.py``'s multi-process tolerances), and the same
iteration count. Without a process group the solver is the one-shard one.
"""

import ctypes

import numpy as np
import pytest

from self_supervise_sfm_tpu.native import ba as JNBA
from self_supervise_sfm_tpu_torch.native import ba as TNBA
from tests._ba_mh_worker import make_worker_problem
from tests._torch_dist_worker import launch, load_tree, save_tree

WORLD = 4
KW = {"plain": dict(max_iters=15, init_lambda=1e-3),
      "huber_gauge": dict(max_iters=15, init_lambda=1e-3, huber_delta=3.0, gauge_fix=True)}
CASES = {f"{kw}_{n}": (n, kw) for n in (2, 4) for kw in KW}


@pytest.fixture(scope="module")
def problem():
    return make_worker_problem()


@pytest.fixture(scope="module")
def one_library_one_thread():
    """The JAX binding on the port's library, one OpenMP thread."""
    path = TNBA.build()
    saved_build, saved_lib = JNBA.build, JNBA._lib
    JNBA.build, JNBA._lib = (lambda force=False: path), None
    lib = ctypes.CDLL(path)
    lib.omp_get_max_threads.restype = ctypes.c_int
    threads = lib.omp_get_max_threads()
    lib.omp_set_num_threads(1)
    try:
        yield
    finally:
        lib.omp_set_num_threads(threads)
        JNBA.build, JNBA._lib = saved_build, saved_lib


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, problem):
    TNBA.build()  # once, before the ranks load it
    tmp = tmp_path_factory.mktemp("ba_multihost")
    names = ("ext", "K", "pts", "ci", "pi", "uv")
    cases = []
    for name, (n, kw) in CASES.items():
        save_tree(tmp / f"{name}.in.npz", dict(zip(names, problem)))
        cases.append(dict(name=name, kind="ba", mesh=[n, 1, 1], kw=KW[kw]))
    launch(dict(cases=cases), WORLD, tmp)
    return {name: [load_tree(tmp / f"{name}.r{r}.npz") for r in range(n)]
            for name, (n, _) in CASES.items()}


@pytest.mark.parametrize("case", CASES)
def test_multihost_matches_the_n_shard_solver(ranks, problem, one_library_one_thread, case):
    n, kw = CASES[case]
    e_ref, p_ref, i_ref = JNBA.ba_solve_distributed(*problem, num_shards=n, **KW[kw])
    for r in ranks[case]:
        np.testing.assert_allclose(r["ext"].numpy(), e_ref, atol=1e-6)
        np.testing.assert_allclose(r["pts"].numpy(), p_ref, atol=1e-6)
        np.testing.assert_allclose(float(r["final_cost"]), i_ref["final_cost"], rtol=1e-9)
        assert int(r["iterations"]) == i_ref["iterations"]
        assert int(r["num_processes"]) == n


def test_every_rank_returns_the_whole_solution(ranks):
    for case, rs in ranks.items():
        for r in rs[1:]:
            for key in ("ext", "pts", "final_cost"):
                assert np.array_equal(r[key].numpy(), rs[0][key].numpy()), (case, key)


def test_without_a_process_group_it_is_the_one_shard_solver(problem, one_library_one_thread):
    a = TNBA.ba_solve_multihost(*problem, **KW["huber_gauge"])
    b = TNBA.ba_solve_distributed(*problem, num_shards=1, **KW["huber_gauge"])
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[2]["final_cost"] == b[2]["final_cost"] and a[2]["num_processes"] == 1
