"""One gloo rank of the port's multi-process tests, on the CPU.

    python -m tests._torch_dist_worker SPEC RANK WORLD

SPEC is a JSON file ``{"dir": DIR, "cases": [...]}``. The ranks meet
through a file store in DIR (no network port) and run every case in turn;
a case names its kind, its mesh extents ``[data, context, model]`` and its
inputs, ``DIR/<name>.in.npz``; each rank in the case's mesh writes
``DIR/<name>.r<RANK>.npz`` (ranks outside it sit the case out). Weights come
from ``DIR/<file>.npz`` trees written by :func:`save_tree`. This module
imports no JAX: the test modules compute the references and compare.
:func:`launch` starts the ranks from a test module.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


# -- trees of arrays in .npz files ------------------------------------------------


def save_tree(path, tree) -> None:
    """Nested dicts / lists of arrays (numpy or CPU tensors) into one .npz;
    each key is the leaf's path, "d:<key>" for a dict entry and "l:<i>" for a
    list item, joined by "/"."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + [f"d:{k}"])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + [f"l:{i}"])
        elif node is not None:
            a = node.detach().float().numpy() if torch.is_tensor(node) else np.asarray(node)
            flat["/".join(prefix)] = a

    walk(tree, [])
    np.savez(path, **flat)


def load_tree(path):
    """The tree :func:`save_tree` wrote, leaves as CPU tensors."""
    root: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            node = root
            for a, b in zip(parts[:-1], parts[1:]):
                node = node.setdefault(a, {})
            node[parts[-1]] = torch.from_numpy(z[key])

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(k.startswith("l:") for k in node):
            return [build(node[f"l:{i}"]) for i in range(len(node))]
        return {k[2:]: build(v) for k, v in node.items()}

    return build(root)


def launch(spec: dict, world: int, tmp: Path, timeout: float = 180.0) -> None:
    """Run ``world`` ranks of this worker on ``spec``; a rank that fails, or
    a run that outlasts ``timeout`` seconds (a hung rendezvous), fails the
    caller with the ranks' output. Every rank is gone on return."""
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps({"dir": str(tmp), **spec}))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests._torch_dist_worker", str(spec_path), str(r), str(world)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs, failed = [], []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                failed.append(r)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"the {world} gloo ranks did not finish in {timeout} s")
    if failed:
        raise AssertionError(
            f"ranks {failed} failed:\n" + "\n".join(outs[r][-4000:] for r in failed))


# -- the cases ---------------------------------------------------------------------


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad


def _trainable(tree):
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_trainable(v) for v in tree]
    return tree.clone().requires_grad_(True)


def _block_cfg(case):
    from self_supervise_sfm_tpu_torch.layers.block import BlockConfig

    return BlockConfig(dim=case["dim"], num_heads=case["heads"], qk_norm=True)


def _ring(case, inp, d):
    from self_supervise_sfm_tpu_torch.ops import attention_core as AC
    from self_supervise_sfm_tpu_torch.ops import ring_attention as RA
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    mesh = d["mesh"]
    q, k, v = (inp[n].clone().requires_grad_(True) for n in ("q", "k", "v"))
    out = RA.ring_sdpa(q, k, v, mesh)
    torch.sin(out).sum().backward()
    with Sh.activate_mesh(mesh):
        via_sdpa = AC.sdpa(inp["q"], inp["k"], inp["v"], impl="ring")
        odd = [inp[n][:, :, 1:] for n in ("q", "k", "v")]  # N - 1 keys: no ring
        fallback = AC.sdpa(*odd, impl="ring")
    return dict(out=out, dq=q.grad, dk=k.grad, dv=v.grad, via_sdpa=via_sdpa,
                fallback=fallback)


def _gate(case, inp, d):
    from self_supervise_sfm_tpu_torch.ops import ring_attention as RA

    mesh = d["mesh"]
    got = [RA.ring_applicable(torch.zeros(shape), mesh, None) for shape in case["shapes"]]
    got.append(RA.ring_applicable(torch.zeros(case["shapes"][0]), None, None))
    got.append(RA.ring_applicable(torch.zeros(case["shapes"][0]), mesh, object()))
    return dict(applicable=np.array(got))


def _block_case(case, inp, d):
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh
    from self_supervise_sfm_tpu_torch.parallel import sp_block as SP

    mesh, cfg = d["mesh"], _block_cfg(case)
    p = _trainable(d["trees"][case["params"]])
    x = inp["x"].clone().requires_grad_(True)
    ctx = inp["ctx"].clone().requires_grad_(True) if "ctx" in inp else None
    rope = (inp["cos"], inp["sin"]) if "cos" in inp else None
    cuts, reduces = [], []
    scatter, reduce_from_model = SP.scatter, SP.reduce_from_model

    def counted(*a, **kw):  # whether the block cut a shard or took the plain path
        cuts.append(1)
        return scatter(*a, **kw)

    def counted_reduce(*a, **kw):  # whether Megatron's tail ran
        reduces.append(1)
        return reduce_from_model(*a, **kw)

    SP.scatter, SP.reduce_from_model = counted, counted_reduce
    try:
        with Sh.activate_mesh(mesh):
            if case["kind"] == "frame":
                out = SP.frame_block_sharded(p, x, cfg, rope)
            elif case["kind"] == "global":
                out = SP.global_block_ring(p, x, cfg, rope)
            else:
                out = SP.reloc_block_sharded(p, x, ctx, cfg, rope,
                                             (inp["ccos"], inp["csin"]))
    finally:
        SP.scatter, SP.reduce_from_model = scatter, reduce_from_model
    (out ** 2).sum().backward()
    res = dict(out=out, dx=x.grad, params=_grads(p), sharded=np.array(bool(cuts)),
               tp=np.array(bool(reduces)))
    if ctx is not None:
        res["dctx"] = ctx.grad
    return res


def _model_extent(case, inp, d):
    """Each sharded block and the aggregator's layout under a mesh with a
    ``model`` extent: whether it raised, and each block's largest distance
    from the plain block on the same inputs."""
    from self_supervise_sfm_tpu_torch.layers.block import block, block_with_context
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh
    from self_supervise_sfm_tpu_torch.parallel import sp_block as SP

    cfg, p = _block_cfg(case), d["trees"][case["params"]]
    x, ctx = inp["x"], inp["ctx"]
    calls = [(lambda: SP.frame_block_sharded(p, x, cfg), lambda: block(p, x, cfg)),
             (lambda: SP.global_block_ring(p, x, cfg), lambda: block(p, x, cfg)),
             (lambda: SP.reloc_block_sharded(p, x, ctx, cfg),
              lambda: block_with_context(p, x, ctx, cfg))]
    raised, err = [], []
    with Sh.activate_mesh(d["mesh"]):
        for call, plain in calls:
            try:
                out = call()
                raised.append(False)
                with Sh.activate_mesh(None):
                    err.append(float((out - plain()).abs().max()))
            except NotImplementedError:
                raised.append(True)
                err.append(float("inf"))
        shard = SP.scene_shard(1, 2, 2, tp=SP.tp_engaged((cfg,), d["mesh"]))
    return dict(raised=np.array(raised), err=np.array(err),
                tp=np.array(shard is not None and shard.tp))


def _mesh_case(case, inp, d):
    """``shard_batch`` (replicated host data and process-local data), the
    mesh's indices, and the refusals of ``make_mesh``."""
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    mesh = d["mesh"]
    batch = {"images": inp["images"].numpy(), "rank": 3}
    refused = []
    for call in (lambda: Sh.make_mesh(3, 2, 1, device="cpu"),
                 lambda: Sh.make_mesh(1, 1, 1, device="cuda")):
        try:
            call()
            refused.append(False)
        except ValueError:
            refused.append(True)
    return dict(sharded=Sh.shard_batch(batch, mesh)["images"],
                local=Sh.shard_batch(batch, mesh, process_local=True)["images"],
                scalar=np.array(Sh.shard_batch(batch, mesh)["rank"]),
                index=np.array([mesh.index("data"), mesh.index("context"),
                                mesh.index(("data", "context"))]),
                refused=np.array(refused))


def _model_cfg(case):
    from dataclasses import replace

    from self_supervise_sfm_tpu_torch.models import sailrecon as TM

    cfg = TM.make_config(**case["config"])
    if case.get("dpt_heads", True) is False:  # the train step never runs them
        cfg = replace(cfg, enable_point=False, enable_depth=False)
    return cfg


def _scene(case, inp, d):
    """Build, reloc and fast_reloc under the mesh; the variants that refuse a
    mesh; reloc of a second query set when the case has one."""
    from self_supervise_sfm_tpu_torch.models import sailrecon as TM
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    cfg, p = _model_cfg(case), d["trees"][case["params"]]
    res = {}
    with Sh.activate_mesh(d["mesh"]):
        cache, cam = TM.build_scene_cache(p, cfg, inp["anchors"], rank=case["rank"],
                                          subsample_indices=inp["idx"].long(), device="cpu")
        res["preds"] = TM.reloc(p, cfg, cache, cam, inp["queries"], device="cpu")
        res["fast"] = TM.reloc(p, cfg, cache, cam, inp["queries"], fast_reloc=True,
                               device="cpu")
        if "queries2" in inp:
            res["preds2"] = TM.reloc(p, cfg, cache, cam, inp["queries2"], device="cpu")
        refusals = []
        for fn in (lambda: TM.reloc_chunked(p, cfg, cache, cam, inp["queries"], device="cpu"),
                   lambda: TM.build_scene_cache_staged(p, cfg, inp["anchors"], device="cpu"),
                   lambda: TM.reloc_staged(p, cfg, cache, cam, inp["queries"], device="cpu")):
            try:
                fn()
                refusals.append(False)
            except NotImplementedError as e:
                refusals.append("3c" in str(e))
    kv = cache["kv"]
    return dict(res, kv=kv, cam=cam, shards=np.array(cache.get("shards", (0, 0))),
                kv_bytes=np.array(kv.numel() * kv.element_size()),
                refusals=np.array(refusals))


def _forward(case, inp, d):
    from self_supervise_sfm_tpu_torch.models import sailrecon as TM
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    cfg, p = _model_cfg(case), d["trees"][case["params"]]
    A, Q = case["A"], case["Q"]
    with Sh.activate_mesh(d["mesh"]):
        preds = TM.forward(p, cfg, inp["images"], A, Q, rank=case["rank"],
                           subsample_indices=inp["idx"].long(),
                           images_duplicated=case["duplicated"], device="cpu")
    return dict(preds=preds)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.clone()


def _train_cfg(case):
    from self_supervise_sfm_tpu_torch.train import loop as TL
    from self_supervise_sfm_tpu_torch.train.loss import LossConfig

    return TL.TrainConfig(**case["train"], loss=LossConfig(**case["loss"]))


def _leaf_numels(tree):
    """The tree with each tensor replaced by its element count."""
    if isinstance(tree, dict):
        return {k: _leaf_numels(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_numels(v) for v in tree]
    return np.array(tree.numel())


def _train(case, inp, d):
    """The sharded train step for ``case["steps"]`` steps from whole params:
    per step the reduced gradients (:func:`sharded_loss_and_grads`, gathered
    whole), the metrics, the new params (gathered whole); the rank's leaf
    sizes of params, mu and nu; with ``process_local`` each data rank is
    handed its own scenes only."""
    from self_supervise_sfm_tpu_torch.train import loop as TL
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    mesh, cfg, tcfg = d["mesh"], _model_cfg(case), _train_cfg(case)
    batch = {k[2:]: v.numpy() for k, v in inp.items() if k.startswith("b:")}
    local = case.get("process_local", False)
    if local:
        n, i = mesh.shape["data"], mesh.index("data")
        m = batch["images"].shape[0] // n
        batch = {k: v[i * m: (i + 1) * m] for k, v in batch.items()}
    res = {}
    with Sh.activate_mesh(mesh):
        layout = TL.state_layout(cfg, tcfg, mesh)
        state = TL.train_state_from_params(_copy(d["trees"][case["params"]]), tcfg, layout)
        step = TL.make_train_step(cfg, tcfg, "cpu")
        trained = {k: layout.specs[k] for k in TL._TRAINED}
        for i in range(case["steps"]):
            idx = inp[f"idx{i}"].long()
            _, _, grads = TL.sharded_loss_and_grads(
                state["params"], cfg, tcfg, TL.batch_to_device(batch, "cpu"), layout, idx,
                process_local=local)
            res[f"grads{i}"] = _copy(Sh.gather_tree(grads, trained, mesh))
            state, m = step(state, batch, subsample_indices=idx, process_local=local)
            res[f"metrics{i}"] = {k: float(v) for k, v in m.items()}
            # copies: the next step updates the whole leaves in place
            res[f"params{i}"] = _copy(Sh.gather_tree(
                {k: state["params"][k] for k in TL._TRAINED}, trained, mesh))
    res["numel"] = {k: _leaf_numels(t) for k, t in (
        ("params", state["params"]), ("mu", state["opt"]["mu"]), ("nu", state["opt"]["nu"]))}
    res["count"] = np.array([state["opt"]["count"], state["step"]])
    res["fsdp"] = np.array(layout.fsdp)
    return res


def _train_model_extent(case, inp, d):
    """A ``model`` extent above 1: whether the train step and the layout
    raise, whether the layout is tensor-parallel, and whether a state of
    another layout (whole leaves) is refused by the step."""
    from self_supervise_sfm_tpu_torch.models import sailrecon as TM
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh
    from self_supervise_sfm_tpu_torch.train import loop as TL

    cfg, tcfg = _model_cfg(case), _train_cfg(case)
    raised, layout = [], None
    with Sh.activate_mesh(d["mesh"]):
        for call in (lambda: TL.make_train_step(cfg, tcfg, "cpu"),
                     lambda: TL.state_layout(cfg, tcfg)):
            try:
                out = call()
                raised.append(False)
                layout = out if isinstance(out, TL.StateLayout) else layout
            except NotImplementedError:
                raised.append(True)
        whole = TL.train_state_from_params(TM.init_sailrecon(cfg, torch.Generator().manual_seed(0),
                                                             "cpu"), tcfg)
        try:
            TL._check_layout(whole["params"], layout)
            refused = False
        except ValueError:
            refused = True
    return dict(raised=np.array(raised), tp=np.array(layout is not None and layout.tp),
                whole_refused=np.array(refused))


class _Recording:
    """A dataset that notes where each load's rng stands (a fingerprint of
    the (seed, step, slot) stream it was seeded from)."""

    def __init__(self, ds, seen):
        self.ds, self.seen = ds, seen

    def __len__(self):
        return len(self.ds)

    def load_scene(self, idx, rng):
        import copy

        self.seen.append(copy.deepcopy(rng).random())
        return self.ds.load_scene(idx, rng)


def _trainer(case, inp, d):
    """``trainer.run`` on the ranks of the case's mesh (the whole world):
    each rank's load fingerprints, and the final state gathered whole.
    ``copy_from``: rank 0 first copies those checkpoint steps into the
    results directory."""
    import shutil

    import torch.distributed as dist

    from self_supervise_sfm_tpu_torch.train import loop as TL
    from self_supervise_sfm_tpu_torch.train import trainer as TT
    from self_supervise_sfm_tpu_torch.train.loss import LossConfig

    for src, step in case.get("copy_from", []):
        if dist.get_rank() == 0:
            dst = os.path.join(case["trainer"]["results_dir"], "checkpoints", str(step))
            shutil.copytree(os.path.join(src, "checkpoints", str(step)), dst)
        dist.barrier()
    seen = []
    load, model_config = TT.load_scenes, TT._model_config
    TT.load_scenes = lambda *a, **k: _Recording(load(*a, **k), seen)
    if "dpt" in case:
        TT._model_config = lambda c: narrow_dpt_heads(model_config(c), case["dpt"])
    try:
        train = TL.TrainConfig(**case["train"], loss=LossConfig(**case["loss"]))
        state = TT.run(TT.TrainerConfig(**case["trainer"], train=train))
        cfg = TT._model_config(TT.TrainerConfig(**case["trainer"]))
    finally:
        TT.load_scenes, TT._model_config = load, model_config
    layout = TL.state_layout(cfg, train, d["mesh"])
    whole = {"params": layout.gather(state["params"]),
             "mu": layout.gather(state["opt"]["mu"]), "nu": layout.gather(state["opt"]["nu"])}
    out = dict(seen=np.array(seen, np.float64), step=np.array(state["step"]),
               fsdp=np.array(layout.fsdp), numel=_leaf_numels(state["params"]))
    if dist.get_rank() == 0:  # the gathered state is the same on every rank
        out["state"] = whole
    return out


def narrow_dpt_heads(cfg, widths):
    """``cfg`` with both DPT heads at the given ``features`` and
    ``out_channels`` (their default widths hold most of a tiny model's
    parameters, and a trainer test writes several checkpoints)."""
    from dataclasses import replace

    kw = dict(features=widths["features"], out_channels=tuple(widths["out_channels"]))
    return replace(cfg, point=replace(cfg.point, **kw), depth=replace(cfg.depth, **kw))


def _ba(case, inp, d):
    """``ba_solve_multihost`` over the case's ranks (its mesh's group)."""
    from self_supervise_sfm_tpu_torch.native import ba as TNBA

    args = [inp[k].numpy() for k in ("ext", "K", "pts", "ci", "pi", "uv")]
    ext, pts, info = TNBA.ba_solve_multihost(
        *args, group=d["mesh"].group(("data", "context")), **case["kw"])
    return dict(ext=ext, pts=pts, final_cost=np.array(info["final_cost"], np.float64),
                iterations=np.array(info["iterations"]),
                num_processes=np.array(info["num_processes"]))


def _tp_scene(case, inp, d):
    """Build, reloc and fast_reloc under a mesh with a ``model`` extent (the
    cache cut over heads), and reloc against a whole cache (``kv_whole``,
    ``cam_whole``: a one-device build) under the same mesh."""
    from self_supervise_sfm_tpu_torch.models import sailrecon as TM
    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    cfg, p = _model_cfg(case), d["trees"][case["params"]]
    with Sh.activate_mesh(d["mesh"]):
        cache, cam = TM.build_scene_cache(p, cfg, inp["anchors"], rank=case["rank"],
                                          subsample_indices=inp["idx"].long(), device="cpu")
        preds = TM.reloc(p, cfg, cache, cam, inp["queries"], device="cpu")
        fast = TM.reloc(p, cfg, cache, cam, inp["queries"], fast_reloc=True, device="cpu")
        whole = TM.reloc(p, cfg, {"kv": inp["kv_whole"]}, inp["cam_whole"], inp["queries"],
                         device="cpu")
    return dict(kv=cache["kv"], cam=cam, shards=np.array(cache["shards"]), preds=preds,
                fast=fast, whole=whole)


_KINDS = {"ring": _ring, "gate": _gate, "frame": _block_case, "reloc": _block_case,
          "global": _block_case, "model_extent": _model_extent, "mesh": _mesh_case,
          "scene": _scene, "forward": _forward, "train": _train,
          "train_model_extent": _train_model_extent, "trainer": _trainer, "ba": _ba,
          "tp_scene": _tp_scene}


def main(spec_path: str, rank: int, world: int) -> None:
    import torch.distributed as dist

    from self_supervise_sfm_tpu_torch.parallel import sharding as Sh

    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    out_dir = Path(spec["dir"])
    dist.init_process_group("gloo", init_method=f"file://{out_dir / 'store'}",
                            rank=rank, world_size=world)
    trees = {}
    try:
        for case in spec["cases"]:
            mesh = Sh.make_mesh(*case["mesh"], device="cpu")
            if mesh.coordinate is None:
                continue
            for name in ("params",):
                if name in case and case[name] not in trees:
                    trees[case[name]] = load_tree(out_dir / f"{case[name]}.npz")
            inp = load_tree(out_dir / f"{case['name']}.in.npz")
            res = _KINDS[case["kind"]](case, inp, dict(mesh=mesh, trees=trees))
            save_tree(out_dir / f"{case['name']}.r{rank}.npz", res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
