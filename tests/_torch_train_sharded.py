"""The sharded train step's references and ranks, shared by
``tests/test_torch_train_sharded*.py``.

A tiny model (``tests/test_torch_train_step.py``'s, at width 128 so that
the MLP leaves (128 x 512 = 65,536 elements) reach FSDP's cut, as JAX's
``tests/_trainer_mh_worker.py`` sizes it) and a batch of two synthetic
scenes of two frames. JAX's side: ``init_train_state`` (conditioned as the
single-device test conditions it), then two steps of ``make_train_step``
on one device and under ``Sh.make_mesh`` of the module's extents on the
virtual CPU devices of ``tests/conftest.py`` (FSDP on where the data extent
is above 1: ``param_sharding`` placements of the params and the optimizer
state, as ``init_train_state_sharded`` makes them), each compiled once. The
port's side: the same params through ``convert.from_jax_params``, two steps
of the port's sharded step on gloo ranks (``tests/_torch_dist_worker.py``)
with JAX's own scene-token subsample, on the kernel route (the kernels'
plain versions on the CPU; the ring's chunks dense).
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from self_supervise_sfm_tpu.data.imc2021 import IMC2021Scenes, stack_scenes
from self_supervise_sfm_tpu.data.synthetic import make_synthetic_dataset
from self_supervise_sfm_tpu.models import aggregator as JA
from self_supervise_sfm_tpu.models import sailrecon as JM
from self_supervise_sfm_tpu.parallel import sharding as JSh
from self_supervise_sfm_tpu.train import loop as JL
from self_supervise_sfm_tpu.train.loss import LossConfig as JLossConfig
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.train import loop as TL
from tests._torch_dist_worker import launch, load_tree, save_tree

IMG, S, RANK, B = 28, 2, 2, 2
P0 = (IMG // 14) ** 2
KW = dict(img_size=IMG, embed_dim=128, depth=4, num_heads=4, vit_depth=2,
          intermediate_layer_idx=(0, 1, 2, 3))
TRAIN = dict(max_lr=1e-4, warmup_steps=1, total_steps=100, rank=RANK, num_images=S)
LOSS = dict(num_bins=50)
PORT_ROUTE = dict(attn_impl="flash", global_attn_impl="flash", fused_qkv="on",
                  fused_mlp="on")
STEPS = 2
B1 = 0.9
TRAINED = ("aggregator", "camera_head")
# tolerances of tests/test_torch_train_step.py
LOSS_KEYS = ("loss", "loss_cdf_exact", "loss_cdf_approx")


def make_batch():
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_dataset(root, num_scenes=B, num_images=3, image_size=(40, 32))
        ds = IMC2021Scenes(root, sample_num=128, num_images=S, target_size=IMG)
        rng = np.random.default_rng(0)
        return stack_scenes([ds.load_scene(i, rng) for i in range(B)])


def _compile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with LLVM's cheaper code
    generation (the same XLA program, a third less compile time)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


def _condition(state):
    """The pose branch's output layer scaled by 0.01 and its bias set so the
    4 iterations sum to a unit quaternion and 1 rad fields of view."""
    fc2 = state["params"]["camera_head"]["pose_branch"]["fc2"]
    b = (0.01 * fc2["b"]).at[jnp.array([3, 7, 8])].set(0.25)
    fc2 = {"w": 0.01 * fc2["w"], "b": b}
    head = {**state["params"]["camera_head"],
            "pose_branch": {**state["params"]["camera_head"]["pose_branch"], "fc2": fc2}}
    return {**state, "params": {**state["params"], "camera_head": head}}


def _mu(state):
    return [s for s in state["opt_state"] if hasattr(s, "mu")][0].mu


def _host(tree):
    """Copies on the host: ``np.asarray`` of a CPU array may alias a buffer
    that a later program reuses."""
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def jax_runs(batch, meshes):
    """JAX's single-device run and one under each (data, context) or (data,
    context, model) mesh (tensor parallelism at a model extent above 1):
    {"single" | mesh: {"params": [...], "metrics": [...], "grads":
    [...], "idx": [...]}}. The step returns no gradients; with a
    zero-initialised fp32 first moment they are exact functions of it
    (m1 = (1 - b1) g0, m2 = b1 m1 + (1 - b1) g1, read in float64)."""
    cfg = JM.make_config(attn_impl="dense", **KW)
    key0 = jax.random.PRNGKey(0)
    tcfg = JL.TrainConfig(**TRAIN, loss=JLossConfig(**LOSS))
    state0 = _condition(_compile(lambda k: JL.init_train_state(k, cfg, tcfg), key0)(key0))
    state0 = _host(state0)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    out = {"state0": state0}
    for mesh_ext in ["single", *meshes]:
        if mesh_ext == "single":
            mesh, fsdp = None, False
        else:
            nd, nc, nm = (*mesh_ext, 1)[:3]
            mesh, fsdp = JSh.make_mesh(num_data=nd, num_context=nc, num_model=nm), nd > 1
        out[mesh_ext] = _jax_run(cfg, JL.TrainConfig(**TRAIN, loss=JLossConfig(**LOSS),
                                                     fsdp=fsdp), state0, jb, mesh)
    return out


def _jax_run(cfg, tcfg, state0, jb, mesh):
    with JSh.activate_mesh(mesh):
        state, batch = state0, jb
        if mesh is not None:
            rep = JSh.replicated(mesh)
            place = {k: jax.tree.map(lambda _: rep, v) for k, v in state0.items()}
            tp = mesh.shape.get(JSh.MODEL_AXIS, 1) > 1
            if tcfg.fsdp or tp:
                for k in ("params", "opt_state"):
                    place[k] = JSh.param_sharding(mesh, state0[k], fsdp=tcfg.fsdp, tp=tp)
            state = jax.device_put(state0, place)
            batch = JSh.shard_batch(jb, mesh)
        step = _compile(JL.make_train_step(cfg, tcfg, jit_compile=False), state, batch)
        run = {"params": [], "metrics": [], "idx": [],
               "mu": [_host(_mu(state))]}
        for _ in range(STEPS):
            key = jax.random.fold_in(state["key"], state["step"])
            idx = JA._subsample_indices(key, cfg.aggregator, B, S, P0, RANK)
            run["idx"].append(np.asarray(idx)[..., 5:] - 5)  # patch-relative
            state, metrics = step(state, batch)
            run["params"].append(trained_params(_host(state["params"])))
            run["mu"].append(_host(_mu(state)))
            run["metrics"].append({k: float(v) for k, v in metrics.items()})
    mus = run.pop("mu")
    run["grads"] = [convert.from_jax_params(jax.tree.map(
        lambda m1, m0: (m1.astype(np.float64) - B1 * m0.astype(np.float64)) / (1 - B1),
        {k: mus[i + 1][k] for k in TRAINED}, {k: mus[i][k] for k in TRAINED}))
        for i in range(STEPS)]
    return run


def port_config():
    """The port's model: JAX's, without the DPT heads, which the train step
    never runs (JAX's step leaves them at exactly zero gradient)."""
    from dataclasses import replace

    from self_supervise_sfm_tpu_torch.models import sailrecon as TM

    return replace(TM.make_config(**KW, **PORT_ROUTE), enable_point=False, enable_depth=False)


def train_case(name, mesh, fsdp, process_local=False, **train):
    return dict(name=name, kind="train", mesh=[*mesh, 1][:3], params="p0",
                config={**KW, **PORT_ROUTE}, dpt_heads=False,
                train={**TRAIN, "fsdp": fsdp, **train}, loss=LOSS, steps=STEPS,
                process_local=process_local)


def trained_params(jax_params):
    """The port's tree of a JAX params tree, without the DPT heads."""
    return convert.from_jax_params({k: jax_params[k] for k in TRAINED})


def port_ranks(tmp, batch, jax_ref, cases, world):
    """The worker's ranks on ``cases``; {name: [rank results]} for the ranks
    of each case's mesh."""
    save_tree(tmp / "p0.npz", trained_params(jax_ref["state0"]["params"]))
    inp = {f"b:{k}": np.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    inp.update({f"idx{i}": jax_ref["single"]["idx"][i] for i in range(STEPS)})
    for case in cases:
        save_tree(tmp / f"{case['name']}.in.npz", inp if case["kind"] == "train" else {})
    launch(dict(cases=cases), world, tmp, timeout=300)
    return {case["name"]: [load_tree(tmp / f"{case['name']}.r{r}.npz")
                           for r in range(int(np.prod(case["mesh"])))] for case in cases}


def leaves_with_paths(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves_with_paths(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves_with_paths(v, f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


def check_metrics(got, ref, step):
    """test_torch_train_step's tolerances: the loss and its parts atol 1e-5,
    the other metrics rtol 2e-4. A model without DPT heads reports no norm
    for them; JAX's are exactly 0."""
    got = {k: float(v) for k, v in got.items()}
    for head in ("grad_norm_depth", "grad_norm_point"):
        if head not in got and head in ref:
            assert ref[head] == 0.0
            ref = {k: v for k, v in ref.items() if k != head}
    assert set(got) == set(ref)
    assert ref["loss"] < 2.0 and ref["grad_norm_camera"] > 0  # inside the CDF's range
    for key in LOSS_KEYS:
        assert abs(got[key] - ref[key]) <= 1e-5, key
    for key in set(ref) - set(LOSS_KEYS):
        assert abs(got[key] - ref[key]) <= 2e-4 * abs(ref[key]) + 1e-12, key
    assert got["learning_rate"] == (0.0 if step == 0 else np.float32(1e-4))


def check_grads(got, ref):
    """Every trained leaf's gradient, rtol 2e-4 / atol 1e-5."""
    ref = dict(leaves_with_paths(ref))
    got = leaves_with_paths(got)
    assert len(got) == len(ref) > 0
    for path, g in got:
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(ref[path], np.float64),
                                   rtol=2e-4, atol=1e-5, err_msg=path)


def check_params(got, ref):
    """Every trained parameter, atol 1e-6 (matched by key)."""
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    paths = [p for p, _ in leaves_with_paths(got)]
    a, b = TL._flatten(got), Sh.leaves_like(got, ref)
    assert len(a) == len(TL._flatten(ref)) > 0
    for path, x, y in zip(paths, a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=1e-6,
                                   err_msg=path)


def check_slices(ranks, nd, fsdp):
    """Each rank's leaf sizes of params, mu and nu: 1/nd of every leaf FSDP
    cuts, the whole of the others; the bytes as
    ``loop.state_bytes_per_rank`` counts them."""
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    cfg = port_config()
    shapes = TL.param_shapes(cfg)
    specs = Sh.param_sharding({"data": nd}, shapes, fsdp=fsdp)
    for r in ranks:
        assert bool(r["fsdp"]) == (fsdp and nd > 1)
        for key in ("params", "mu", "nu"):
            tree = r["numel"][key]
            got = np.array([int(n) for n in TL._flatten(tree)])
            whole = np.array([t.numel() for t in Sh.leaves_like(tree, shapes)])
            cut = np.array(["data" in s for s in Sh.leaves_like(tree, specs)])
            assert cut.any() == (fsdp and nd > 1)
            np.testing.assert_array_equal(got, np.where(cut, whole // nd, whole), err_msg=key)
            assert int(got.sum()) * 12 == TL.state_bytes_per_rank(cfg, nd, fsdp)
