"""Demo: feed-forward scene reconstruction, optionally tracked, triangulated,
bundle-adjusted and exported as a COLMAP model.

Port of ``self_supervise_sfm_tpu/demos/reconstruct.py``. Per scene it
writes the point cloud (``pred.ply``), the KITTI poses
(``poses_kitti.txt``) and, in ``results.json``, the seconds and the ATE
against the ground-truth poses when the scene carries them. ``--mode
forward`` runs one joint pass over the frames duplicated as anchors and
queries; ``--mode reloc`` builds the scene cache and relocalises every frame
against it (``--chunk``: in query chunks; ``--staged-cache N``: a host cache
in N layer segments; ``--build-chunk``: an anchor-chunked build).
``--tracks-ba`` adds keypoint tracks (the VGGSfM tracker), DLT
triangulation seeded by the predicted poses, bundle adjustment
(``--ba-engine torch``: on the device; ``native``: the C++ engine on the
host) and the COLMAP model (``sparse_txt`` and ``sparse``).

The weights are random from fixed seeds, a reference SAIL-Recon checkpoint
(``--pretrained sailrecon.pt``, through ``utils/converter.py``) or the port
trainer's checkpoint (``--checkpoint``); either's ViT pos embed is
resampled to ``--img-size``. ``--tracker-weights vggsfm_v2_tracker.pt``
loads the VGGSfM tracker's published weights for ``--tracks-ba``.
Everything runs on ``--device`` (``cuda`` by default; without a card that
raises, it never falls back to the CPU).

Usage:
  python -m self_supervise_sfm_tpu_torch.demos.reconstruct --data-root <imc_root> \\
      [--mode forward|reloc] [--num-images 5] [--tracks-ba] [--device cpu] \\
      [--pretrained sailrecon.pt] [--tracker-weights vggsfm_v2_tracker.pt]

:func:`run` takes the parsed arguments and any dataset object with
``__len__`` and ``load_scene(idx, rng)``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models import sailrecon as M
from ..utils import export as EX
from ..utils.evaluation import absolute_trajectory_error

_MODEL_SEED = 0
_TRACKER_SEED = 2


def make_config(args) -> M.SailReconConfig:
    model_kw = {}
    if args.depth != 24:
        # the trainer's spread of the four DPT taps over a non-flagship depth
        model_kw["intermediate_layer_idx"] = tuple(
            round((i + 1) * args.depth / 4) - 1 for i in range(4))
    return M.make_config(img_size=args.img_size, compute_dtype=args.compute_dtype,
                         depth=args.depth, vit_depth=args.vit_depth, **model_kw)


def load_params(cfg, generator: torch.Generator, checkpoint: str = "", device="cuda",
                pretrained: str = ""):
    """Random params from ``generator``; or a reference SAIL-Recon state dict
    (``pretrained``) through the converter; or the params of the port
    trainer's latest checkpoint under ``checkpoint``; on ``device``, the ViT
    pos embed resampled to the config's grid and the trunk's weights cast to
    the compute dtype."""
    dev = M._device(device)
    if pretrained:
        from ..utils import converter as C

        print(f"loading pretrained torch checkpoint: {pretrained}")
        agg = cfg.aggregator
        params = _to_device(C.convert_sailrecon(C.load_torch_state_dict(pretrained),
                                                agg.depth, agg.vit.depth), dev)
    elif checkpoint:
        from ..train.checkpoint import CheckpointManager

        state = CheckpointManager(checkpoint).restore()
        if state is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint}")
        print(f"loaded trained params (step {int(state['step'])}) from {checkpoint}")
        params = _to_device(state["params"], dev)
    else:
        print("WARNING: no --pretrained or --checkpoint; using random weights")
        return M.cast_trunk_weights(M.init_sailrecon(cfg, generator, dev), cfg)
    from ..layers.vit import resample_pos_embed

    vit = params["aggregator"]["vit"]
    target_grid = cfg.img_size // cfg.aggregator.vit.patch_size
    if vit["pos_embed"].shape[1] != target_grid * target_grid + 1:
        # weights made at another img_size: resample their grid
        print(f"resampling ViT pos embed {vit['pos_embed'].shape[1] - 1} -> "
              f"{target_grid * target_grid} patch tokens")
        vit["pos_embed"] = resample_pos_embed(vit["pos_embed"], target_grid)
    return M.cast_trunk_weights(params, cfg)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev) if torch.is_tensor(tree) else tree


@torch.no_grad()
def reconstruct_scene(params, cfg, images_np, mode: str, rank: int,
                      generator: torch.Generator, chunk: int = 0,
                      staged_segments: int = 0, build_chunk: int = 0,
                      device="cuda") -> Dict[str, Any]:
    """images_np (S, H, W, 3) -> host (numpy) predictions for the S views.

    ``chunk`` > 0 relocalises in query chunks of that size;
    ``staged_segments`` > 0 builds a host-staged cache in that many layer
    segments and relocalises segment by segment; ``build_chunk`` > 0 chunks
    the staged build's anchors (it must divide the frame count).
    """
    dev = M._device(device)
    images = torch.from_numpy(np.asarray(images_np, np.float32)).to(dev)[None]
    S = images.shape[1]
    if mode != "forward" and staged_segments > 0:
        cache, cam_tok = M.build_scene_cache_staged(
            params, cfg, images, rank=rank, generator=generator,
            num_segments=staged_segments,
            anchor_chunk=build_chunk if build_chunk > 0 else None, device=dev)
        preds = M.reloc_staged(params, cfg, cache, cam_tok, images,
                               num_segments=staged_segments, device=dev)
    elif mode == "forward":
        # one pass over the frames duplicated into anchors and queries
        dup = torch.cat([images, images], dim=1)
        preds = M.forward(params, cfg, dup, S, S, rank=rank, generator=generator,
                          images_duplicated=True, device=dev)
    else:
        cache, cam_tok = M.build_scene_cache(params, cfg, images, rank=rank,
                                             generator=generator, device=dev)
        if chunk > 0:
            preds = M.reloc_chunked(params, cfg, cache, cam_tok, images, chunk=chunk,
                                    device=dev)
        else:
            preds = M.reloc(params, cfg, cache, cam_tok, images, device=dev)
    return EX.to_cpu(preds)


def init_tracker(device="cuda", weights: str = ""):
    """(tracker params, tracker config) of ``--tracks-ba``: the VGGSfM
    tracker checkpoint ``weights`` through the converter, or random weights
    from a fixed seed."""
    from ..pipeline.vggsfm_tracker import VGGSfMTrackerConfig, init_vggsfm_tracker

    dev = M._device(device)
    tcfg = VGGSfMTrackerConfig()
    if weights:
        from ..utils import converter as C

        print(f"loading tracker weights: {weights}")
        tp = C.convert_vggsfm_tracker(C.load_torch_state_dict(weights), tcfg)
        return _to_device(tp, dev), tcfg
    print("WARNING: no --tracker-weights; using random tracker weights")
    gen = torch.Generator(device=dev).manual_seed(_TRACKER_SEED)
    return init_vggsfm_tracker(tcfg, gen, dev), tcfg


def track_and_bundle_adjust(scene, preds, args, out_dir: str, tracker_params, tracker_cfg,
                            device="cuda", timings: Optional[dict] = None):
    """Track keypoints across the scene, triangulate with the predicted
    poses and intrinsics, bundle-adjust, and export the COLMAP model (text
    and binary) and the adjusted KITTI poses. Returns the point and
    observation counts, or None when there is no keypoint or no point
    survives the gating."""
    from ..pipeline import tracking as T
    from ..utils.colmap_io import reconstruction_to_batch_matrix

    timings = {} if timings is None else timings
    out = T.predict_tracks(
        tracker_params, scene["images"],
        query_frame_num=min(3, scene["images"].shape[0]),
        max_query_pts=args.max_query_pts, tracker_cfg=tracker_cfg,
        fine_tracking=args.fine_tracking, device=device, timings=timings)
    if out is None:
        print("  tracks-ba: no keypoints found, skipping")
        return None
    tracks, vis, _ = out
    H, W = scene["images"].shape[1:3]
    rec = T.tracks_to_reconstruction(
        tracks, vis, np.asarray(preds["extrinsic"][0], np.float32),
        np.asarray(preds["intrinsic"][0], np.float32), image_size=(W, H),
        run_ba=True, ba_engine=args.ba_engine, device=device, timings=timings)
    if rec is None:
        print("  tracks-ba: no valid tracks survived gating, skipping")
        return None
    t0 = time.perf_counter()
    rec.write_text(os.path.join(out_dir, "sparse_txt"))
    rec.write_binary(os.path.join(out_dir, "sparse"))
    _, ba_ext, _ = reconstruction_to_batch_matrix(rec)
    EX.save_kitti_poses(ba_ext, os.path.join(out_dir, "poses_kitti_ba.txt"))
    timings["export"] = timings.get("export", 0.0) + time.perf_counter() - t0
    return {"ba_points": len(rec.points3d),
            "ba_tracks": int(sum(len(p.track) for p in rec.points3d.values()))}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--out-dir", default="demo_out")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card, cuda raises")
    ap.add_argument("--mode", choices=["forward", "reloc"], default="forward")
    ap.add_argument("--num-images", type=int, default=5)
    ap.add_argument("--img-size", type=int, default=518)
    ap.add_argument("--rank", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=0,
                    help="reloc mode: query chunk size (0: one batched call)")
    ap.add_argument("--staged-cache", type=int, default=0,
                    help="reloc mode: host-staged cache in N layer segments (0: on "
                         "the device)")
    ap.add_argument("--build-chunk", type=int, default=0,
                    help="with --staged-cache: anchor-chunked build (the chunk size "
                         "must divide the frame count)")
    ap.add_argument("--num-scenes", type=int, default=3)
    ap.add_argument("--pretrained", default="",
                    help="a reference SAIL-Recon checkpoint (sailrecon.pt) to convert "
                         "and serve")
    ap.add_argument("--checkpoint", default="",
                    help="the port trainer's checkpoint directory (use --depth / "
                         "--vit-depth to match the trained shape)")
    ap.add_argument("--depth", type=int, default=24)
    ap.add_argument("--vit-depth", type=int, default=24)
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--tracks-ba", action="store_true",
                    help="also track, triangulate, bundle-adjust and export a COLMAP "
                         "sparse model")
    ap.add_argument("--tracker-weights", default="",
                    help="a VGGSfM tracker checkpoint (vggsfm_v2_tracker.pt) for "
                         "--tracks-ba")
    ap.add_argument("--ba-engine", choices=["torch", "native"], default="torch")
    ap.add_argument("--max-query-pts", type=int, default=2048)
    ap.add_argument("--fine-tracking", action="store_true", default=True)
    ap.add_argument("--no-fine-tracking", dest="fine_tracking", action="store_false")
    return ap.parse_args(argv)


def run(args, dataset, params=None, tracker_params=None, tracker_cfg=None) -> Dict[str, Any]:
    """The demo over ``dataset`` (``__len__`` and ``load_scene(idx, rng)``).

    ``params`` / ``tracker_params`` (with ``tracker_cfg``): weights on the
    device to use in place of the seeded random ones. Returns the results
    dict that it also writes to ``<out-dir>/results.json``; each entry
    carries the seconds of each stage under ``stage_seconds``.
    """
    dev = M._device(args.device)
    cfg = make_config(args)
    if params is None:
        params = load_params(cfg, torch.Generator(device=dev).manual_seed(_MODEL_SEED),
                             args.checkpoint, dev, args.pretrained)
    if args.tracks_ba and tracker_params is None:
        tracker_params, tracker_cfg = init_tracker(dev, args.tracker_weights)
    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    results = {}
    for si in range(min(args.num_scenes, len(dataset))):
        scene = dataset.load_scene(si, rng)
        name = scene["scene_name"]
        out_dir = os.path.join(args.out_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        # scene si's token subsample: a generator seeded si
        gen = torch.Generator(device=dev).manual_seed(si)
        stages: Dict[str, float] = {}
        t0 = time.perf_counter()
        preds = reconstruct_scene(params, cfg, scene["images"], args.mode, args.rank, gen,
                                  chunk=args.chunk, staged_segments=args.staged_cache,
                                  build_chunk=args.build_chunk, device=dev)
        dt = time.perf_counter() - t0
        stages[args.mode] = dt
        S = scene["images"].shape[0]
        t0 = time.perf_counter()
        per_view = [{"point_map": preds["point_map"][0, i], "xyz_cnf": preds["xyz_cnf"][0, i],
                     "images": scene["images"][i]} for i in range(S)]
        EX.save_pointcloud_ply(per_view, os.path.join(out_dir, "pred.ply"))
        EX.save_kitti_poses(preds["extrinsic"][0], os.path.join(out_dir, "poses_kitti.txt"))
        stages["export"] = time.perf_counter() - t0
        entry: Dict[str, Any] = {"seconds": round(dt, 2), "frames": S}
        if "poses_w2c_gt" in scene:
            entry.update(absolute_trajectory_error(preds["extrinsic"][0],
                                                   scene["poses_w2c_gt"][:, :3]))
        if args.tracks_ba:
            ba = track_and_bundle_adjust(scene, preds, args, out_dir, tracker_params,
                                         tracker_cfg, dev, stages)
            if ba:
                entry.update(ba)
        entry["stage_seconds"] = stages
        results[name] = entry
        print(name, entry, flush=True)
    with open(os.path.join(args.out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    args = parse_args(argv)
    M._device(args.device)
    from ..data.imc2021 import IMC2021Scenes

    ds = IMC2021Scenes(args.data_root, sample_num=16, num_images=args.num_images,
                       target_size=args.img_size)
    return run(args, ds)


if __name__ == "__main__":
    main()
