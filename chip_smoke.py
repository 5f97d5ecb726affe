#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``self_supervise_sfm_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each of which must pass (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   kernel in ``self_supervise_sfm_tpu_torch/csrc`` with ``nvcc`` for sm_90a;
   the registers, spills and shared memory of the Hopper attention body's
   kernels (K1, K2, K2p, K1m), of the Hopper backward body's (B9's dq and
   dk/dv, unmasked and under a RelocMask; a spill in either body fails the
   run)
   and of the Hopper GEMM body's (MLP-up, MLP-down, the probe, the
   layer-norm pre-pass, LN+QKV+RoPE, LN+QKV, the out-projection), and any
   ptxas advisory that wgmma was serialised (C7518);
2. the GEMM body's operand layouts alone (``gemm_probe``: one tile, then
   ragged rows and a K loop, against an fp32 matmul); each of the twelve
   kernels at the shapes of the paths below, held against its plain
   PyTorch version with the tolerance stated, and timed (CUDA events,
   median) beside its plain version, the PyTorch library call (for the
   fused block kernels: the chain of library calls) computing the same
   function (a yardstick the port never calls) and its bound: the larger of
   its operations at the bf16 tensor-core peak and its bytes at the memory
   peak of an H100 SXM (989 TFLOP/s, 3.35 TB/s); for every site of K1, K2,
   K2p and the fused block kernels the kernel's ratio to its bound and to
   its library call, per call and 20 launches back to back; the layer-norm
   pre-pass of LN+QKV(+RoPE) and MLP-up alone; K3 at its two sites: the
   DPT head's (its rate on its bound's bytes beside the most its
   back-to-back time lets it move; bit-equal to the one-chunk launch and to
   one image a chunk) and the fine tracker's, (5120, 16, 16, 32) -> 31 x
   31 fp32 with no addend (within an fp32 ulp of the plain version,
   bit-equal across chunkings, timed with every image in one chunk and with
   the chunk ``ops/resize.py:image_chunk`` picks, beside ``F.interpolate``
   and its bound), and K3 at the edges of its thread mapping (4 and 8
   channels a thread, ragged pixel counts, one image a chunk); B9 at the edges of its tiling and at the train step's sites,
   its RelocMask forms at the edges of their work tiles, at reloc layer 0
   and at the 5-query mask-form shape, a repeat bit-equal, the pair (dq +
   dk/dv) against SDPA's backward; K1m (the flash forward under a
   RelocMask) at the 5-query shape bit-equal to K2p on the same problem and
   within tolerance of its plain version there and at the edges of its
   segment maps, each edge bit-equal to K2 on the unfolded tensors;
3. the full-width joint forward: ViT-L/14 + 24 aggregator layers at 518 px,
   bf16 trunk and fp32 heads, 5 anchors + the same 5 images as queries,
   rank 300, random weights from a seeded generator, every trunk block on
   the fused LN+QKV / out-proj / MLP kernels. Launch counts are read around
   one forward; the same forward with every kernel site on its plain
   PyTorch path must agree with it (within the bf16 envelope that an fp32
   forward measures) and give finite poses and point maps. The path with
   only the attention and resize kernels on (the fused block kernels off)
   is timed in the same run. The default configuration (``make_config()``:
   fp32, ``attn_impl="auto"``) runs once at the same width: no attention or
   fused block kernel may launch (they take bf16 only), and it must agree
   with the fp32 plain forward to fp32 rounding;
4. two-phase serving at the same width and with the same weights:
   ``build_scene_cache`` of the 5 anchors, then ``reloc`` (full heads and
   ``fast_reloc``) of the 5 images against the cache, with launch counts
   around one build and one reloc (the in-place kv2 kernel 24 times a reloc),
   the cache and the reloc taps against the plain-path build / reloc, the
   reloc taps against the joint forward's query taps of phase 3, and timings;
   then a 20-anchor scene: one-shot, anchor-chunked and host-staged builds
   against each other, ``reloc_staged`` against the resident ``reloc`` bit
   for bit, ``reloc_chunked`` against ``reloc``, times and peaks of each.

5. the self-supervised train step at full width (``bench.py:bench_train``'s
   configuration at depth 24: 2 frames of 518 px duplicated as anchors and
   queries, rank 300, bf16 trunk on fp32 master weights, Adam with a bf16
   first moment, each aggregator layer rematerialised) on a batch of 2 pairs
   x 10 000 correspondences made from known poses: launch counts of one
   step against the code's prediction (the B9 backward kernels among them),
   four steps (the first at learning rate 0), finite losses, nonzero trunk
   and camera gradients, untouched DPT heads, the gradients against the
   plain path's within twice the bf16-vs-fp32 envelope, times, peak memory
   and a profile of one step, with B9's device ms a step.

6. the trainer (``train/trainer.py:run``) around phase 5's full-width step,
   on numpy-made synthetic scenes at 518 px (no ``h5py`` needed; artifact
   dumps off, so no matplotlib either): run A takes 6 steps with
   checkpoints at steps 3 and 6, a profile window over one step, one
   sanity check and one validation (one 8-frame scene, 2048
   correspondences a pair); the step-6 checkpoint
   restored bit-equal to run A's state; the spread of one step from the
   step-3 checkpoint restored twice; run B resumes from the step-3
   checkpoint and is held against run A within that spread (bit-equal when
   it is 0). It prints the trainer's steps/s against phase 5's bare step,
   the profiled step's idle share and launches, validation and sanity-check
   ms, checkpoint GB and save / write / restore seconds, and peak GB; run
   A's launch counts go into the kernel line as the "trainer" path.

7. the reconstruction demo (``demos/reconstruct.py:run``) with phase 3's
   weights and the default ``VGGSfMTrackerConfig()`` (random weights from
   a seed) on a numpy-made 5-frame scene (``SyntheticScenes`` with a fine
   checkerboard on its plane, so that the keypoint detector finds 2048
   corners a frame): ``--mode forward`` and ``--mode reloc`` with
   ``--tracks-ba`` and 2048 query points, each with its launch counts
   (phase 3's, or phase 4's build plus reloc, plus one K3 launch per
   tracker chunk of >= 4365 patches), its PLY / KITTI / ``results.json``
   outputs and, when a reconstruction survives the gating, its COLMAP
   models read back (text against binary); the seconds of each stage; the
   tracker with K3 against the einsum path on 1024 queries (patch features
   within phase 3's fp32 envelope, tracks after one fine iteration within
   1e-3 px; the default six iterations printed for the record); the DINO
   ranking through K1 and LN+QKV against the plain path; one tracking call
   profiled (idle share, launches); bundle adjustment on known geometry
   (the plane's points projected with the true poses and K plus 0.5 px
   noise, the poses perturbed) at 5 frames x 6144 and 20 frames x 10,240
   tracks with the torch engine (twice: its spread) and the native one:
   each must bring the RMSE down to the noise and the ATE down, and the
   two engines' final Huber costs must agree within 1e-3; the peak GB. Its
   launch counts are the kernel line's "demo" path.

``python3 chip_smoke.py --kernels-only`` stops after phase 2;
``--train-only`` runs phase 5 alone after the build, ``--trainer-only``
phases 5 and 6, ``--demo-only`` phase 7 (their launch counts are then not
merged into the kernel line, which is not printed).

The line before the last is a JSON object of every kernel's numbers (the
forward's and the serving paths' numbers go on lines of their own before
it); the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

# per call: the median of calls each between two events; back to back: 20
# calls queued behind a spin of the device (tools/timing.py)
from self_supervise_sfm_tpu_torch.tools.timing import back_to_back_ms as _back_to_back_ms
from self_supervise_sfm_tpu_torch.tools.timing import per_call_ms as _time_ms

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
NUM_FRAMES = 5
IMG = 518
RANK = 300
SEED = 0
# K1, K1m, K2 and K2p: one attention body written for Hopper
SM90_SOURCE = "self_supervise_sfm_tpu_torch/csrc/flash_fwd_sm90.cu"
# LN+QKV+RoPE, LN+QKV, the out-projection, MLP-up and MLP-down: one GEMM
# body written for Hopper
GEMM_SOURCE = "self_supervise_sfm_tpu_torch/csrc/gemm_sm90.cu"


# launches of each kernel wrapper in one call at full width (depth 24, 5
# frames): the joint forward (24 ViT + 24 x (frame, reloc, global) blocks),
# a scene-cache build (24 ViT + 24 x (frame, global); the context K/V
# unfused) and a reloc (24 ViT + 24 x (frame, reloc against the cache in
# place)); ``fast_reloc`` decodes no dense head, so no K3
_ZERO = dict.fromkeys(("flash_fwd", "frame_ctx_fwd", "frame_ctx_packed_fwd", "flash_fwd_reloc",
                       "resize_bilinear", "fused_ln_qkv_rope", "fused_ln_qkv",
                       "fused_proj_residual", "fused_mlp_up", "fused_mlp_down", "flash_bwd_dq",
                       "flash_bwd_dkv"), 0)
FORWARD_LAUNCHES = {**_ZERO, "flash_fwd": 72, "frame_ctx_fwd": 24, "resize_bilinear": 2,
                    "fused_ln_qkv_rope": 72, "fused_ln_qkv": 24, "fused_proj_residual": 96,
                    "fused_mlp_up": 96, "fused_mlp_down": 96}
BUILD_LAUNCHES = {**_ZERO, "flash_fwd": 72, "fused_ln_qkv": 24, "fused_ln_qkv_rope": 48,
                  "fused_proj_residual": 72, "fused_mlp_up": 72, "fused_mlp_down": 72}
FAST_RELOC_LAUNCHES = {**_ZERO, "flash_fwd": 48, "frame_ctx_packed_fwd": 24, "fused_ln_qkv": 24,
                       "fused_ln_qkv_rope": 48, "fused_proj_residual": 72, "fused_mlp_up": 72,
                       "fused_mlp_down": 72}
RELOC_LAUNCHES = {**FAST_RELOC_LAUNCHES, "resize_bilinear": 2}


def _wall_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# kernel-name patterns of each class, checked in order
_KERNEL_CLASSES = (
    # the port's own kernels first: a name holding "gemm" or "norm" further
    # down must not claim them
    ("fused_ln_qkv_rope", ("ln_qkv_rope_sm90_kernel",)),
    ("fused_ln_qkv", ("ln_qkv_sm90_kernel",)),
    ("fused_proj_residual", ("proj_residual_sm90_kernel",)),
    ("fused_mlp_up", ("mlp_up_sm90_kernel",)),
    ("fused_mlp_down", ("mlp_down_sm90_kernel",)),
    ("ln_rows (pre-pass of LN+QKV(+RoPE) and MLP-up)", ("ln_rows_kernel",)),
    ("flash_fwd (K1)", ("flash_fwd_kernel",)),
    ("flash_bwd_dq (B9)", ("flash_bwd_dq_sm90_kernel", "flash_bwd_dq_reloc_sm90_kernel")),
    ("flash_bwd_dkv (B9)", ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dkv_reloc_sm90_kernel")),
    ("frame_ctx_fwd (K2)", ("frame_ctx_fwd_kernel",)),
    ("frame_ctx_kv2_fwd (K2p)", ("frame_ctx_kv2_fwd_kernel",)),
    ("flash_fwd_reloc (K1m)", ("flash_fwd_reloc_sm90_kernel",)),
    ("resize_bilinear (K3)", ("resize_bilinear_ac_kernel",)),
    ("convolution", ("conv", "fprop", "dgrad", "winograd", "implicit")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("softmax / reduction", ("softmax", "reduce", "norm")),
    ("copy / layout", ("copy", "cat", "transpose", "memcpy", "memset", "index",
                       "gather", "scatter")),
)


def profile_forward(fn, label: str = "forward") -> dict:
    """One call of ``fn`` under torch.profiler: device time by kernel class,
    the top kernels, and the device's idle share of the profiled wall time
    (the profiler's own host cost included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("  profiler: no device events recorded; breakdown not measured")
        return {"measured": False}
    classes = {name: 0.0 for name, _ in _KERNEL_CLASSES}
    classes["elementwise / other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        cls = next((n for n, pats in _KERNEL_CLASSES if any(p in key for p in pats)),
                   "elementwise / other")
        classes[cls] += e.self_device_time_total / 1e3
    busy_ms = sum(classes.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    print(f"  profiled {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), {sum(e.count for e in kernels)} "
          f"kernel launches")
    for name, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"    {name}: {ms:.2f} ms ({ms / busy_ms:.3f})")
    for e in top:
        print(f"    top: {e.self_device_time_total / 1e3:8.2f} ms x{e.count:5d}  {e.key[:90]}")
    return {"measured": True, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "launches": sum(e.count for e in kernels), "classes_ms": classes,
            "top": [[e.key[:120], e.self_device_time_total / 1e3, e.count] for e in top]}


def _bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _site_line(label: str, r: dict) -> None:
    """One site's times and its ratios to its bound and its library call,
    per call and back to back."""
    print(f"  {label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
          f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
          f"kernel / bound {r['ms'] / r['bound_ms']:.2f}x, kernel / library "
          f"{r['ms'] / r['library_ms']:.2f}x; back to back kernel "
          f"{r['back_to_back_ms']:.4f} ms, library {r['library_back_to_back_ms']:.4f} ms "
          f"({r['back_to_back_ms'] / r['library_back_to_back_ms']:.2f}x)")


def _entry_name(mangled: str) -> str:
    """The last name of an Itanium-mangled nested name (_ZN<len><id>...):
    the kernel's own name, without its namespace or template arguments."""
    i, name = mangled.find("_ZN") + 3, "?"
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    return name


def print_build_log(log: str) -> None:
    """ptxas's registers and spills of every kernel, each line under the
    name of its kernel, and any warning or performance advisory (such as
    wgmma serialisation)."""
    name = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = _entry_name(line)
        elif "Used" in line or "spill" in line:
            print(f"  ptxas {name}: {line.strip().removeprefix('ptxas info    : ')}")
        elif "warning" in line or "Performance" in line:
            print(f"  {line.strip()}")


def print_sm90_build() -> None:
    """Registers a thread at launch, spills and dynamic shared memory of the
    Hopper attention, backward and GEMM bodies' kernels as the runtime
    reports them, and the setmaxnreg counts they were built with."""
    import ctypes

    from self_supervise_sfm_tpu_torch import _kernels

    names = ("flash_fwd_kernel", "frame_ctx_fwd_kernel", "frame_ctx_kv2_fwd_kernel",
             "flash_fwd_reloc_sm90_kernel")
    lib = _kernels.library()
    for which, name in enumerate(names):
        info = (ctypes.c_int * 8)()
        rc = lib.sfm_attention_sm90_info(which, info)
        if rc != 0:
            raise RuntimeError(f"sfm_attention_sm90_info({which}): CUDA error {rc}")
        print(f"  {name}: {info[0]} registers a thread at launch, {info[1]} local bytes, "
              f"{info[2]} bytes of dynamic shared memory, {info[3]} stages of {info[5]} keys, "
              f"{info[4]} q rows a tile, setmaxnreg {info[6]} (producer) / {info[7]} "
              f"(consumers)")
        if info[1]:
            raise AssertionError(f"{name}: {info[1]} bytes of spills a thread")
    names = ("mlp_up_sm90_kernel", "mlp_down_sm90_kernel", "gemm_probe_sm90_kernel",
             "ln_rows_kernel", "ln_qkv_rope_sm90_kernel", "ln_qkv_sm90_kernel",
             "proj_residual_sm90_kernel")
    for which, name in enumerate(names):
        info = (ctypes.c_int * 10)()
        rc = lib.sfm_gemm_sm90_info(which, info)
        if rc != 0:
            raise RuntimeError(f"sfm_gemm_sm90_info({which}): CUDA error {rc}")
        if which == 3:
            print(f"  {name}: {info[0]} registers a thread, {info[1]} local bytes")
            continue
        print(f"  {name}: {info[0]} registers a thread at launch, {info[1]} local bytes, "
              f"{info[2]} bytes of dynamic shared memory, {info[3]} stages, tiles of "
              f"{info[4]} x {info[5]}, {'ping-pong' if info[8] else 'cooperative'}, raster "
              f"groups of {info[9]} row tiles, setmaxnreg {info[6]} (producer) / {info[7]} "
              f"(consumers)")
    for which, name in enumerate(("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel",
                                  "flash_bwd_dq_reloc_sm90_kernel",
                                  "flash_bwd_dkv_reloc_sm90_kernel")):
        info = (ctypes.c_int * 8)()
        rc = lib.sfm_flash_bwd_sm90_info(which, info)
        if rc != 0:
            raise RuntimeError(f"sfm_flash_bwd_sm90_info({which}): CUDA error {rc}")
        dq = which % 2 == 0
        print(f"  {name}: {info[0]} registers a thread at launch, {info[1]} local bytes, "
              f"{info[2]} bytes of dynamic shared memory, {info[3]} stages of {info[5]} "
              f"{'keys' if dq else 'q rows'}, {info[4]} "
              f"{'q rows' if dq else 'keys'} a work tile, setmaxnreg {info[6]} "
              f"(producer) / {info[7]} (consumers)")
        if info[1]:
            raise AssertionError(f"{name}: {info[1]} bytes of spills a thread")
    advisories = [ln.strip() for ln in _kernels.build_log.splitlines() if "C7518" in ln]
    print(f"  ptxas wgmma serialisation advisories (C7518): {advisories or 'none'}")


def _check(name: str, err: float, tol: float) -> None:
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}) {status}")
    if err > tol:
        raise AssertionError(f"{name}: error {err} over tolerance {tol}")


def _logit(key: str, v):
    """Map a head output back to the scale of its logit: log for the exp
    depth and the 1 + exp confidences (softplus of the logit), sign *
    log1p|v| for the inverse-log point maps and the world points.
    Overflowed entries stay inf."""
    import torch

    if key in ("depth_map", "xyz_cnf", "dpt_cnf"):
        # subnormal outputs (logit below log of the smallest normal) carry
        # too few bits to invert: counted with the underflowed ones
        tiny = torch.finfo(torch.float32).tiny
        return torch.where(v < tiny, float("-inf"), torch.log(v))
    return torch.sign(v) * torch.log1p(v.abs())


def check_kernels(gen):
    """Phase 2: every kernel at the main path's shapes against its plain
    version; returns per-kernel measurements (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops import resize as RS

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # bf16 outputs differ by whole ulps where the fp32 sums of kernel and
    # plain version straddle a rounding boundary: tolerance n ulps at the
    # largest output
    def ulps(ref, n):
        return n * 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)

    results = []
    # -- K1: flash forward at the ViT, frame and global sites ---------------
    sites = []
    N = (IMG // 14) ** 2 + 5
    for site, bh, n in (("vit", NUM_FRAMES * 16, N), ("frame", 2 * NUM_FRAMES * 16, N),
                        ("global", 16, NUM_FRAMES * N)):
        q, k, v = randn(bh, n, 64), randn(bh, n, 64), randn(bh, n, 64)
        out, lse = FA.flash_fwd(q, k, v)
        torch.cuda.synchronize()
        p_out, p_lse = FA.flash_fwd_plain(q, k, v)
        err = float((out.float() - p_out.float()).abs().max())
        _check(f"flash_fwd[{site}] out {tuple(q.shape)}", err, ulps(p_out, 4))
        _check(f"flash_fwd[{site}] lse", float((lse - p_lse).abs().max()), 1e-4)
        bound, by = _bound_ms(4.0 * bh * n * n * 64, 4 * q.numel() * 2 + lse.numel() * 4)
        q4, k4, v4 = (t.view(1, bh, n, 64) for t in (q, k, v))
        sites.append(dict(
            site=site, shape=[bh, n, 64], max_abs_err=err,
            ms=_time_ms(lambda: FA.flash_fwd(q, k, v)),
            plain_ms=_time_ms(lambda: FA.flash_fwd_plain(q, k, v), reps=5),
            library_ms=_time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
            bound_ms=bound, bound_by=by,
            back_to_back_ms=_back_to_back_ms(lambda: FA.flash_fwd(q, k, v)),
            library_back_to_back_ms=_back_to_back_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4)),
        ))
        del q, k, v, out, lse, p_out, p_lse
    for s_ in sites:
        _site_line(f"flash_fwd[{s_['site']}] {tuple(s_['shape'])}", s_)
    results.append(dict(
        name="flash_fwd", route="cuda", source=SM90_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:140",
        # one call at each of the three sites (one ViT + one aggregator layer)
        max_abs_err=max(s["max_abs_err"] for s in sites),
        **{k: sum(s[k] for s in sites) for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=sites[-1]["bound_by"], sites=sites,
    ))

    # -- K2: [context ‖ own frame] attention at the reloc site --------------
    P, nc = N, NUM_FRAMES * (RANK + 5)
    q, k, v = (randn(NUM_FRAMES, 16, P, 64) for _ in range(3))
    ck, cv = randn(1, 16, nc, 64), randn(1, 16, nc, 64)
    out = FA.frame_ctx_fwd(q, k, v, ck, cv)
    torch.cuda.synchronize()
    ref = FA._frame_ctx_dense(q, k, v, ck, cv)
    err = float((out.float() - ref.float()).abs().max())
    _check(f"frame_ctx_fwd {tuple(q.shape)} ctx {tuple(ck.shape)}", err, ulps(ref, 4))
    kk = torch.cat([ck.expand(NUM_FRAMES, -1, -1, -1), k], dim=2)
    vv = torch.cat([cv.expand(NUM_FRAMES, -1, -1, -1), v], dim=2)
    bound, by = _bound_ms(4.0 * NUM_FRAMES * 16 * P * (nc + P) * 64,
                          (4 * q.numel() + 2 * ck.numel()) * 2)
    results.append(dict(
        name="frame_ctx_fwd", route="cuda", source=SM90_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:539",
        max_abs_err=err,
        ms=_time_ms(lambda: FA.frame_ctx_fwd(q, k, v, ck, cv)),
        plain_ms=_time_ms(lambda: FA._frame_ctx_dense(q, k, v, ck, cv), reps=5),
        # SDPA over the [ctx ‖ own] K/V concatenated beforehand
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(q, kk, vv)),
        bound_ms=bound, bound_by=by,
        back_to_back_ms=_back_to_back_ms(lambda: FA.frame_ctx_fwd(q, k, v, ck, cv)),
        library_back_to_back_ms=_back_to_back_ms(
            lambda: F.scaled_dot_product_attention(q, kk, vv)),
    ))
    _site_line(f"frame_ctx_fwd {tuple(q.shape)} ctx {nc}", results[-1])
    del q, k, v, ck, cv, kk, vv, out, ref

    # -- K3: final DPT upsample 296 -> 518 with the fused pos-embed addend --
    H0 = 4 * (IMG // 14) * 2  # 296
    x = randn(NUM_FRAMES, H0, H0, 128, dtype=torch.float32)
    add = randn(IMG, IMG, 128, dtype=torch.float32)
    out = RS.resize_bilinear_fwd(x, (IMG, IMG), add, torch.bfloat16)
    torch.cuda.synchronize()
    ref = RS.resize_bilinear_plain(x, (IMG, IMG), add, torch.bfloat16)
    err = float((out.float() - ref.float()).abs().max())
    _check(f"resize_bilinear {tuple(x.shape)} -> {IMG} bf16", err, ulps(ref, 1))
    err32 = float((RS.resize_bilinear_fwd(x, (IMG, IMG), add)
                   - RS.resize_bilinear_plain(x, (IMG, IMG), add)).abs().max())
    _check("resize_bilinear fp32 store", err32, 1e-5 * float(ref.float().abs().max()))

    def library():
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(IMG, IMG), mode="bilinear",
                          align_corners=True)
        return (y.permute(0, 2, 3, 1) + add).to(torch.bfloat16)

    # the bound's bytes: x, the addend and the output once each
    bound_bytes = x.numel() * 4 + add.numel() * 4 + out.numel() * 2
    bound, by = _bound_ms(0.0, bound_bytes)
    kernel = lambda: RS.resize_bilinear_fwd(x, (IMG, IMG), add, torch.bfloat16)  # noqa: E731
    # the DPT site's chunk is every image: the launch of the one-chunk mapping
    chunk_dpt = RS.image_chunk(NUM_FRAMES, IMG, IMG, 128)
    one = RS.resize_bilinear_fwd(x, (IMG, IMG), add, torch.bfloat16, img_chunk=NUM_FRAMES)
    split = RS.resize_bilinear_fwd(x, (IMG, IMG), add, torch.bfloat16, img_chunk=1)
    torch.cuda.synchronize()
    dpt_equal = torch.equal(out, one) and torch.equal(out, split)
    print(f"  resize_bilinear DPT site: chosen chunk {chunk_dpt} of {NUM_FRAMES} images; "
          f"bit-equal to the one-chunk launch and to one image a chunk: {dpt_equal}")
    if chunk_dpt != NUM_FRAMES or not dpt_equal:
        raise AssertionError("resize_bilinear: the DPT site moved off the one-chunk launch")
    dpt = dict(
        site="dpt", shape=list(x.shape), out_hw=[IMG, IMG], img_chunk=chunk_dpt,
        max_abs_err=err, max_abs_err_fp32=err32,
        ms=_time_ms(kernel),
        plain_ms=_time_ms(lambda: RS.resize_bilinear_plain(x, (IMG, IMG), add,
                                                           torch.bfloat16), reps=5),
        library_ms=_time_ms(library),
        bound_ms=bound, bound_by=by,
        back_to_back_ms=_back_to_back_ms(kernel),
        library_back_to_back_ms=_back_to_back_ms(library),
    )
    _site_line(f"resize_bilinear {tuple(x.shape)} -> {IMG} bf16", dpt)
    # a model, not a measurement: the device-memory bytes if the addend is
    # read once a call (the bound's) or once an image, beside the most that
    # the measured back-to-back time lets the kernel move at the memory peak
    per_image = bound_bytes + (x.shape[0] - 1) * add.numel() * 4
    print(f"  resize_bilinear: {bound_bytes / dpt['ms'] / 1e6:.1f} GB/s a call "
          f"({bound_bytes / dpt['back_to_back_ms'] / 1e6:.1f} back to back) on the bound's "
          f"{bound_bytes / 1e6:.1f} MB; model (not measured): {bound_bytes / 1e6:.1f} MB "
          f"if the addend is read once a call, {per_image / 1e6:.1f} MB if once an image; "
          f"at the memory peak its back-to-back time allows at most "
          f"{dpt['back_to_back_ms'] * 1e-3 * PEAK_BYTES_PER_S / 1e6:.1f} MB")
    del x, add, out, ref, one, split
    torch.cuda.empty_cache()
    tracker = check_tracker_resize()
    results.append(dict(
        name="resize_bilinear", route="cuda",
        source="self_supervise_sfm_tpu_torch/csrc/resize.cu",
        replaces="self_supervise_sfm_tpu/ops/resize.py:51,136",
        # one call at each of the two sites (the DPT head, the fine tracker)
        max_abs_err=max(dpt["max_abs_err"], tracker["max_abs_err"]),
        **{k: dpt[k] + tracker[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by="bytes", sites=[dpt, tracker],
    ))
    # K3 at the edges of its thread mapping, inputs from a generator of their
    # own: 8 channels a thread (C = 24) and 4 (C = 12), 429 / 286 threads (no
    # multiple of the block), with and without the addend, both stores
    k3 = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for c in (24, 12):
        xe = torch.randn((3, 5, 7, c), generator=k3, device="cuda")
        for adde in (None, torch.randn((11, 13, c), generator=k3, device="cuda")):
            for dt in (torch.bfloat16, torch.float32):
                got = RS.resize_bilinear_fwd(xe, (11, 13), adde, dt)
                torch.cuda.synchronize()
                ref = RS.resize_bilinear_plain(xe, (11, 13), adde, dt)
                tol = ulps(ref, 1) if dt == torch.bfloat16 else 1e-5 * float(ref.abs().max())
                _check(f"resize_bilinear edge (3, 5, 7, {c}) -> (11, 13) "
                       f"{'with' if adde is not None else 'no'} addend {dt}",
                       float((got.float() - ref.float()).abs().max()), tol)
    results += check_fused_kernels(randn, ulps)
    # inputs from a generator of their own: the weights of phase 3 are drawn
    # from `gen` after this phase, and stay what they were before these checks
    # were added
    own = torch.Generator(device="cuda").manual_seed(SEED + 3)
    results += check_serving_kernels(
        lambda *shape: torch.randn(shape, generator=own, device="cuda").to(torch.bfloat16),
        ulps)
    edges = torch.Generator(device="cuda").manual_seed(SEED + 7)
    check_attention_edges(
        lambda *shape: torch.randn(shape, generator=edges, device="cuda").to(torch.bfloat16),
        ulps)
    bwd = torch.Generator(device="cuda").manual_seed(SEED + 5)
    results += check_backward_kernels(
        lambda *shape, dtype=torch.bfloat16: torch.randn(
            shape, generator=bwd, device="cuda").to(dtype), ulps)
    for r in results:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return results


def check_tracker_resize():
    """Phase 2, K3 at the fine tracker's site: every 16 x 16 x 32 patch
    feature of 5 frames x 1024 points upsampled to 31 x 31, fp32, no addend,
    against the plain version (an fp32 ulp, as the DPT site's fp32 store),
    bit-equal across chunkings, timed with every image in one chunk (the
    mapping before the image chunks) and with the chosen chunk, beside the
    plain version, ``F.interpolate`` and the bound. Inputs from a generator
    of their own."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import resize as RS

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    n, hw = NUM_FRAMES * 1024, (31, 31)
    x = torch.randn((n, 16, 16, 32), generator=gen, device="cuda")
    chunk = RS.image_chunk(n, *hw, 32)
    if not RS.resize_kernel_applicable(tuple(x.shape), hw) or chunk >= n:
        raise AssertionError(f"tracker site: gate or chunk ({chunk}) off the design")
    out = RS.resize_bilinear_fwd(x, hw)
    one = RS.resize_bilinear_fwd(x, hw, img_chunk=n)
    torch.cuda.synchronize()
    ref = RS.resize_bilinear_plain(x, hw)
    err = float((out - ref).abs().max())
    _check(f"resize_bilinear tracker site {tuple(x.shape)} -> {hw} fp32", err,
           1e-5 * float(ref.abs().max()))
    same = torch.equal(out, one)
    print(f"  resize_bilinear tracker site: chunk {chunk} ({-(-n // chunk)} chunks) bit-equal "
          f"to one chunk of {n} images: {same}")
    if not same:
        raise AssertionError("resize_bilinear: the chunked launch differs from one chunk")

    def library():
        return F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                             align_corners=True)

    bound, by = _bound_ms(0.0, x.numel() * 4 + out.numel() * 4)
    site = dict(
        site="tracker", shape=list(x.shape), out_hw=list(hw), img_chunk=chunk,
        max_abs_err=err,
        ms=_time_ms(lambda: RS.resize_bilinear_fwd(x, hw)),
        one_chunk_ms=_time_ms(lambda: RS.resize_bilinear_fwd(x, hw, img_chunk=n)),
        plain_ms=_time_ms(lambda: RS.resize_bilinear_plain(x, hw), reps=5),
        library_ms=_time_ms(library),
        bound_ms=bound, bound_by=by,
        back_to_back_ms=_back_to_back_ms(lambda: RS.resize_bilinear_fwd(x, hw)),
        one_chunk_back_to_back_ms=_back_to_back_ms(
            lambda: RS.resize_bilinear_fwd(x, hw, img_chunk=n)),
        library_back_to_back_ms=_back_to_back_ms(library),
    )
    _site_line(f"resize_bilinear tracker site {tuple(x.shape)} -> {hw} fp32, chunk {chunk}",
               site)
    print(f"  resize_bilinear tracker site, one chunk of {n} images (the mapping before "
          f"the chunks): {site['one_chunk_ms']:.4f} ms a call, "
          f"{site['one_chunk_back_to_back_ms']:.4f} ms back to back; chunk {chunk}: "
          f"{site['ms']:.4f} / {site['back_to_back_ms']:.4f} ms; bound {bound:.4f} ms")
    return site


def check_attention_edges(randn, ulps):
    """Phase 2, K1 / K2 / K2p at the edges of the Hopper body's tiling, held
    against their plain versions with the path shapes' tolerances: one q row
    and one key, a second warpgroup whose 64 rows all lie past nq, ragged q
    and key tiles, no context at all, two scenes each with its context, and
    K2p bit-equal to K2 on the split copies."""
    import torch

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA

    for bh, nq, nk in ((2, 1, 1), (3, 50, 70), (2, 130, 333), (1, 200, 128)):
        q, k, v = randn(bh, nq, 64), randn(bh, nk, 64), randn(bh, nk, 64)
        out, lse = FA.flash_fwd(q, k, v)
        torch.cuda.synchronize()
        p_out, p_lse = FA.flash_fwd_plain(q, k, v)
        _check(f"flash_fwd edge ({bh}, {nq}, {nk})",
               float((out.float() - p_out.float()).abs().max()), ulps(p_out, 4))
        _check(f"flash_fwd edge ({bh}, {nq}, {nk}) lse", float((lse - p_lse).abs().max()), 1e-4)
    for B, F, H, P, nc in ((2, 2, 2, 50, 0), (2, 2, 2, 130, 77), (1, 3, 2, 1, 300)):
        q, k, v = (randn(B * F, H, P, 64) for _ in range(3))
        ckv = randn(2, B, H, nc, 128)
        ck, cv = ckv[1, ..., :64].contiguous(), ckv[1, ..., 64:].contiguous()
        out = FA.frame_ctx_fwd(q, k, v, ck, cv)
        packed = FA.frame_ctx_packed_fwd(q, k, v, ckv, 1)
        torch.cuda.synchronize()
        ref = FA._frame_ctx_dense(q, k, v, ck, cv)
        _check(f"frame_ctx_fwd edge B{B} F{F} P{P} nc{nc}",
               float((out.float() - ref.float()).abs().max()), ulps(ref, 4))
        if not torch.equal(packed, out):
            raise AssertionError(f"frame_ctx_packed_fwd edge nc{nc}: not bit-equal to K2")
    print("  edges: frame_ctx_packed_fwd bit-equal to frame_ctx_fwd at each")


def check_fused_kernels(randn, ulps):
    """Phase 2, the five fused block kernels at the ViT, frame, reloc and
    global sites. bf16 outputs: kernel and plain version sum in other orders,
    so a layer-normed operand or a result may round to the neighbouring
    bf16 value; the tolerance is 2 ulps at the largest output, and 4 for
    q / k, where the qk-norm and the two RoPE products each round again.
    The library chain is the unfused block code (fp32 ``F.layer_norm``, cuBLAS
    matmul, chunk / transpose, ``F.gelu``, elementwise RoPE and residual)."""
    import torch

    from self_supervise_sfm_tpu_torch.layers import attention as AT
    from self_supervise_sfm_tpu_torch.layers import params as P
    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.ops import fused_qkv as FQ

    C, H, d, Ch = 1024, 16, 64, 4096
    N = (IMG // 14) ** 2 + 5
    f32 = torch.float32
    bf16 = torch.bfloat16
    norm = lambda n: {"scale": 1 + 0.1 * randn(n, dtype=f32),  # noqa: E731
                      "bias": 0.1 * randn(n, dtype=f32)}
    lin = lambda i, o: {"w": (randn(i, o, dtype=f32) * i**-0.5).to(bf16),  # noqa: E731
                        "b": 0.1 * randn(o, dtype=f32)}
    p = {"norm1": norm(C), "norm2": norm(C),
         "attn": {"qkv": lin(C, 3 * C), "proj": lin(C, C), "q_norm": norm(d),
                  "k_norm": norm(d)},
         "mlp": {"fc1": lin(C, Ch), "fc2": lin(Ch, C)},
         "ls1": {"gamma": randn(C, dtype=f32)}, "ls2": {"gamma": randn(C, dtype=f32)}}
    acfg = AG.AggregatorConfig()
    t_frame = AG._rope_tables_frame(acfg, IMG // 14, IMG // 14, "cuda")
    t_global = AG._tile_tables(t_frame, NUM_FRAMES)
    attn_cfg = AT.AttentionConfig(dim=C, num_heads=H, qk_norm=True, ln_eps=1e-5)
    vit_cfg = AT.AttentionConfig(dim=C, num_heads=H, qk_norm=False, ln_eps=1e-6)
    n1, n2, at, ml = p["norm1"], p["norm2"], p["attn"], p["mlp"]
    qn, kn = at["q_norm"], at["k_norm"]
    sites = {"vit": (NUM_FRAMES, N, None), "frame": (2 * NUM_FRAMES, N, t_frame),
             "reloc": (NUM_FRAMES, N, t_frame), "global": (1, NUM_FRAMES * N, t_global)}

    # the MLP kernels' GEMM body alone, fp32 accumulators against an fp32
    # matmul of the same bf16 operands: one tile of one K slice (the weight
    # read MN-major through the transposed-B bit, two 64-column atoms), then
    # ragged rows, several tiles and a K loop through the whole ring. Sums in
    # other orders: tolerance 1e-4 sqrt(K), far below a misplaced operand.
    # Inputs from a generator of their own, so that the other inputs of
    # this phase and the weights of phase 3 stay what they were
    probe = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for rows, kk, cols in ((128, 64, 128), (300, 1024, 384)):
        a = torch.randn((rows, kk), generator=probe, device="cuda").to(bf16)
        w = (torch.randn((kk, cols), generator=probe, device="cuda") * kk**-0.5).to(bf16)
        got = FQ.gemm_probe(a, w)
        torch.cuda.synchronize()
        ref = torch.matmul(a.float(), w.float())
        _check(f"gemm_probe ({rows} x {kk}) @ ({kk} x {cols})",
               float((got - ref).abs().max()), 1e-4 * kk**0.5)
        del a, w, got, ref

    def measure(name, site, outs, refs, tol_ulps, flops, tensors_in, fns):
        """One kernel at one site: check, bound, and the timings: per call
        and 20 launches back to back, beside the library chain's."""
        torch.cuda.synchronize()
        err = 0.0
        for o, r, label in zip(outs, refs, ("q", "k", "v") if len(outs) == 3 else ("y",)):
            e = float((o.float() - r.float()).abs().max())
            _check(f"{name}[{site}] {label} {tuple(o.shape)}", e,
                   ulps(r, tol_ulps[label]))
            err = max(err, e)
        in_bytes = sum(t.numel() * t.element_size() for t in tensors_in)
        out_bytes = sum(o.numel() * o.element_size() for o in outs)
        bound, by = _bound_ms(flops, in_bytes + out_bytes)
        kernel, plain, library = fns
        return dict(site=site, shape=list(tensors_in[0].shape), max_abs_err=err,
                    ms=_time_ms(kernel), plain_ms=_time_ms(plain, reps=5),
                    library_ms=_time_ms(library), bound_ms=bound, bound_by=by,
                    back_to_back_ms=_back_to_back_ms(kernel),
                    library_back_to_back_ms=_back_to_back_ms(library),
                    input_mb=in_bytes / 1e6, inputs_fit_l2=in_bytes <= 50e6)

    def prepass(name, site, x, norm, eps):
        """The layer-norm pre-pass of a kernel alone (inside its time above):
        hn against the plain version's rows, 2 ulps at the largest; timed."""
        M = x.shape[0] * x.shape[1]
        hn = torch.empty((M, C), dtype=bf16, device="cuda")
        FQ._ln_rows_into(hn, x, norm["scale"], norm["bias"], eps)
        torch.cuda.synchronize()
        hn_ref = FQ._ln_rows(x.float(), norm["scale"], norm["bias"], eps).to(bf16).view(M, C)
        e_hn = float((hn.float() - hn_ref.float()).abs().max())
        _check(f"{name}[{site}] layer-norm pre-pass hn {tuple(hn.shape)}", e_hn,
               ulps(hn_ref, 2))
        pre = lambda: FQ._ln_rows_into(hn, x, norm["scale"], norm["bias"], eps)  # noqa: E731
        per_kernel[name][-1].update(
            prepass_max_abs_err=e_hn, prepass_ms=_time_ms(pre),
            prepass_back_to_back_ms=_back_to_back_ms(pre))

    per_kernel = {k: [] for k in ("fused_ln_qkv_rope", "fused_ln_qkv", "fused_proj_residual",
                                  "fused_mlp_up", "fused_mlp_down")}
    for site, (B, n, tabs) in sites.items():
        M = B * n
        x = randn(B, n, C)
        # -- LN + QKV (+ qk-norm + RoPE) -> q, k, v (B, H, n, 64)
        if tabs is None:
            args = (x, n1["scale"], n1["bias"], at["qkv"]["w"], at["qkv"]["b"], H, 1e-6)
            kern, plain, name = FQ.fused_ln_qkv_fwd, FQ.fused_ln_qkv_plain, "fused_ln_qkv"
            chain = lambda: tuple(t.contiguous() for t in AT.qkv_heads(  # noqa: E731
                at, P.layer_norm(n1, x, 1e-6), vit_cfg))
            ins = [x, at["qkv"]["w"], at["qkv"]["b"], n1["scale"], n1["bias"]]
            tol = {"q": 2, "k": 2, "v": 2}
        else:
            args = (x, n1["scale"], n1["bias"], at["qkv"]["w"], at["qkv"]["b"],
                    qn["scale"], qn["bias"], kn["scale"], kn["bias"], *tabs, H, 1e-5)
            kern, plain = FQ.fused_ln_qkv_rope_fwd, FQ.fused_ln_qkv_rope_plain
            name = "fused_ln_qkv_rope"
            chain = lambda: tuple(t.contiguous() for t in AT.qkv_heads(  # noqa: E731
                at, P.layer_norm(n1, x, 1e-5), attn_cfg, tabs))
            ins = [x, at["qkv"]["w"], at["qkv"]["b"], n1["scale"], n1["bias"],
                   qn["scale"], qn["bias"], kn["scale"], kn["bias"], *tabs]
            tol = {"q": 4, "k": 4, "v": 2}
        per_kernel[name].append(measure(
            name, site, kern(*args), plain(*args), tol, 2.0 * M * C * 3 * C, ins,
            (lambda: kern(*args), lambda: plain(*args), chain)))
        prepass(name, site, x, n1, args[-1])
        if site == "reloc":
            continue  # the other three kernels see the ViT site's shape again
        # -- head merge + out-proj + layer-scale + residual
        o = randn(B, H, n, d)
        pargs = (o, x, at["proj"]["w"], at["proj"]["b"], p["ls1"]["gamma"])
        per_kernel["fused_proj_residual"].append(measure(
            "fused_proj_residual", site, [FQ.fused_proj_residual_fwd(*pargs)],
            [FQ.fused_proj_residual_plain(*pargs)], {"y": 2}, 2.0 * M * C * C, list(pargs),
            (lambda: FQ.fused_proj_residual_fwd(*pargs),
             lambda: FQ.fused_proj_residual_plain(*pargs),
             lambda: x + P.layer_scale(p["ls1"], P.linear(at["proj"], AT._merge_heads(o))))))
        # -- MLP up: LN2 + fc1 + GELU -> hidden
        uargs = (x, n2["scale"], n2["bias"], ml["fc1"]["w"], ml["fc1"]["b"], 1e-5)
        h = FQ.fused_mlp_up(*uargs)
        per_kernel["fused_mlp_up"].append(measure(
            "fused_mlp_up", site, [h], [FQ.fused_mlp_up_plain(*uargs)], {"y": 2},
            2.0 * M * C * Ch, list(uargs[:5]),
            (lambda: FQ.fused_mlp_up(*uargs), lambda: FQ.fused_mlp_up_plain(*uargs),
             lambda: P.gelu(P.linear(ml["fc1"], P.layer_norm(n2, x, 1e-5))))))
        prepass("fused_mlp_up", site, x, n2, 1e-5)
        # -- MLP down: fc2 + layer-scale + residual, on the up kernel's hidden
        dargs = (h, x, ml["fc2"]["w"], ml["fc2"]["b"], p["ls2"]["gamma"])
        per_kernel["fused_mlp_down"].append(measure(
            "fused_mlp_down", site, [FQ.fused_mlp_down(*dargs)],
            [FQ.fused_mlp_down_plain(*dargs)], {"y": 2}, 2.0 * M * Ch * C, list(dargs),
            (lambda: FQ.fused_mlp_down(*dargs), lambda: FQ.fused_mlp_down_plain(*dargs),
             lambda: x + P.layer_scale(p["ls2"], P.linear(ml["fc2"], h)))))
        del x, o, h
        torch.cuda.empty_cache()

    lines = {"fused_ln_qkv_rope": 158, "fused_ln_qkv": 309, "fused_proj_residual": 411,
             "fused_mlp_up": 526, "fused_mlp_down": 546}
    results = []
    for name, ss in per_kernel.items():
        for s_ in ss:
            print(f"  {name}[{s_['site']}]: kernel {s_['ms']:.4f} ms, plain "
                  f"{s_['plain_ms']:.4f} ms, library chain {s_['library_ms']:.4f} ms, "
                  f"bound {s_['bound_ms']:.4f} ms ({s_['bound_by']}), "
                  f"roofline share {s_['bound_ms'] / s_['ms']:.3f}, "
                  f"inputs {s_['input_mb']:.1f} MB "
                  f"({'fit' if s_['inputs_fit_l2'] else 'exceed'} the 50 MB L2); "
                  f"back to back kernel {s_['back_to_back_ms']:.4f} ms, library chain "
                  f"{s_['library_back_to_back_ms']:.4f} ms "
                  f"({s_['back_to_back_ms'] / s_['library_back_to_back_ms']:.2f}x), "
                  f"{s_['bound_ms'] / s_['back_to_back_ms'] * PEAK_BF16_FLOPS / 1e12:.0f} "
                  f"TFLOP/s")
            if "prepass_ms" in s_:
                print(f"  {name}[{s_['site']}] layer-norm pre-pass alone: "
                      f"{s_['prepass_ms']:.4f} ms a call, {s_['prepass_back_to_back_ms']:.4f} "
                      f"ms back to back")
        results.append(dict(
            name=name, route="cuda", source=GEMM_SOURCE,
            replaces=f"self_supervise_sfm_tpu/ops/fused_qkv.py:{lines[name]}",
            # one call at each site measured
            max_abs_err=max(s_["max_abs_err"] for s_ in ss),
            **{k: sum(s_[k] for s_ in ss)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            bound_by=ss[-1]["bound_by"], sites=ss,
        ))
    return results


def check_serving_kernels(randn, ulps):
    """Phase 2, the two kernels of the serving path: the [context | own
    frame] attention that reads a layer of the kv2 scene cache in place
    (K2p), and the flash forward under a RelocMask (K1m). bf16 outputs,
    tolerance 4 ulps at the largest output as for K1 / K2, the lse within
    1e-4. K1m runs K2's body over segment maps: on the same problem it must
    equal K2p bit for bit, and at the edges of its maps K2 on the unfolded
    tensors."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import attention_core as AC
    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

    H, d, depth, Fq = 16, 64, 24, NUM_FRAMES
    P = (IMG // 14) ** 2 + 5
    q, k, v = (randn(Fq, H, P, d) for _ in range(3))

    def library(ckv, layer):
        # SDPA with what it needs first: the layer's slice, the k / v split,
        # the broadcast over frames and the concatenation with the own K/V
        ck, cv = ckv[layer, ..., :d], ckv[layer, ..., d:]
        kk = torch.cat([ck.expand(Fq, -1, -1, -1), k], dim=2)
        vv = torch.cat([cv.expand(Fq, -1, -1, -1), v], dim=2)
        return F.scaled_dot_product_attention(q, kk, vv)

    # -- K2p at the 5-anchor cache (first and last layer) and at 20 anchors --
    sites = []
    for anchors, layers in ((NUM_FRAMES, (0, depth - 1)), (4 * NUM_FRAMES, (depth // 2,))):
        nc = anchors * (RANK + 5)
        ckv = randn(depth, 1, H, nc, 2 * d)
        before = ckv.clone()
        for layer in layers:
            out = FA.frame_ctx_packed_fwd(q, k, v, ckv, layer)
            torch.cuda.synchronize()
            ref = FA.frame_ctx_packed_plain(q, k, v, ckv, layer)
            err = float((out.float() - ref.float()).abs().max())
            name = f"frame_ctx_packed_fwd[{anchors} anchors, layer {layer}]"
            _check(f"{name} {tuple(q.shape)} cache {tuple(ckv.shape)}", err, ulps(ref, 4))
            # the same body as K2: bit-equal on the layer's split copies
            k2 = FA.frame_ctx_fwd(q, k, v, ckv[layer, ..., :d].contiguous(),
                                  ckv[layer, ..., d:].contiguous())
            if not torch.equal(out, k2):
                raise AssertionError(f"{name}: not bit-equal to K2 on the split copies")
            bound, by = _bound_ms(4.0 * Fq * H * P * (nc + P) * d,
                                  (4 * q.numel() + H * nc * 2 * d) * 2)
            sites.append(dict(
                site=f"{anchors} anchors, layer {layer}", shape=list(q.shape),
                cache_shape=list(ckv.shape), max_abs_err=err,
                ms=_time_ms(lambda: FA.frame_ctx_packed_fwd(q, k, v, ckv, layer)),
                plain_ms=_time_ms(lambda: FA.frame_ctx_packed_plain(q, k, v, ckv, layer),
                                  reps=5),
                library_ms=_time_ms(lambda: library(ckv, layer)),
                bound_ms=bound, bound_by=by,
                back_to_back_ms=_back_to_back_ms(
                    lambda: FA.frame_ctx_packed_fwd(q, k, v, ckv, layer)),
                library_back_to_back_ms=_back_to_back_ms(lambda: library(ckv, layer))))
        if not torch.equal(ckv, before):
            raise AssertionError("frame_ctx_packed_fwd wrote to the cache")
        for bad in (-1, depth):
            try:
                FA.frame_ctx_packed_fwd(q, k, v, ckv, bad)
            except IndexError:
                continue
            raise AssertionError(f"frame_ctx_packed_fwd took layer {bad}")
        if anchors == NUM_FRAMES:
            ckv5 = ckv
        del before
    print("  frame_ctx_packed_fwd: bit-equal to frame_ctx_fwd (K2) on the split copies")
    results = [dict(
        name="frame_ctx_packed_fwd", route="cuda", source=SM90_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:661",
        # one call at each site measured
        max_abs_err=max(s_["max_abs_err"] for s_ in sites),
        **{key: sum(s_[key] for s_ in sites)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        bound_by=sites[0]["bound_by"], sites=sites)]

    # -- K1m on the same problem in mask form: rows of all frames at once ----
    nc = NUM_FRAMES * (RANK + 5)
    mask = RelocMask(nc, P, Fq)

    def unfold(x):  # (F, H, P, d) frame-major -> (1, H, F*P, d)
        return x.transpose(0, 1).reshape(1, H, Fq * P, d).contiguous()

    ck = ckv5[0, ..., :d].contiguous()
    cv = ckv5[0, ..., d:].contiguous()
    qm, ks, vs = unfold(q), unfold(k), unfold(v)
    km, vm = torch.cat([ck, ks], dim=2), torch.cat([cv, vs], dim=2)
    q3, k3, v3 = qm[0], km[0], vm[0]
    out, lse = FA.flash_fwd_reloc(q3, k3, v3, mask)
    torch.cuda.synchronize()
    p_out, p_lse = FA.flash_fwd_plain(q3, k3, v3, mask)
    err = float((out.float() - p_out.float()).abs().max())
    _check(f"flash_fwd_reloc out {tuple(q3.shape)} x {tuple(k3.shape)} {mask}", err,
           ulps(p_out, 4))
    _check("flash_fwd_reloc lse", float((lse - p_lse).abs().max()), 1e-4)
    # the three forms of the one problem agree: mask, split and layout; the
    # mask form is the layout form's walk over other maps, bit for bit
    layout = unfold(FA.frame_ctx_packed_fwd(q, k, v, ckv5, 0))[0]
    split = AC.reloc_split_attention(qm, ks, vs, ck, cv, mask)[0]
    _check("mask form vs layout form (K2p)", float((out.float() - layout.float()).abs().max()),
           ulps(p_out, 4))
    if not torch.equal(out, layout):
        raise AssertionError("flash_fwd_reloc: not bit-equal to K2p on the same problem")
    print("  flash_fwd_reloc (K1m): bit-equal to frame_ctx_packed_fwd (K2p) on the same problem")
    _check("split form vs layout form (K2p)",
           float((split.float() - layout.float()).abs().max()), ulps(p_out, 4))
    dense_mask = mask.materialize("cuda")
    allowed = Fq * P * (nc + P)  # entries the mask allows, per head
    bound, by = _bound_ms(4.0 * H * allowed * d,
                          (2 * q3.numel() + 2 * k3.numel()) * 2 + lse.numel() * 4)
    kernel = lambda: FA.flash_fwd_reloc(q3, k3, v3, mask)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(qm, km, vm, attn_mask=dense_mask)  # noqa: E731
    split_form = lambda: AC.reloc_split_attention(qm, ks, vs, ck, cv, mask)  # noqa: E731
    r = dict(
        name="flash_fwd_reloc", route="cuda", source=SM90_SOURCE,
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:140",
        variant="mask=RelocMask", max_abs_err=err, shape=list(q3.shape),
        ms=_time_ms(kernel),
        plain_ms=_time_ms(lambda: FA.flash_fwd_plain(q3, k3, v3, mask), reps=3, warmup=1),
        # SDPA with the materialised boolean mask
        library_ms=_time_ms(library),
        bound_ms=bound, bound_by=by,
        back_to_back_ms=_back_to_back_ms(kernel),
        library_back_to_back_ms=_back_to_back_ms(library),
        # the same problem in the other two forms, for the record
        split_form_ms=_time_ms(split_form),
        split_form_back_to_back_ms=_back_to_back_ms(split_form),
        layout_form_ms=sites[0]["ms"], layout_form_back_to_back_ms=sites[0]["back_to_back_ms"])
    print(f"  one reloc attention, three forms: mask (K1m) {r['ms']:.4f} ms "
          f"(b2b {r['back_to_back_ms']:.4f}), split (two K1 calls + lse merge) "
          f"{r['split_form_ms']:.4f} ms (b2b {r['split_form_back_to_back_ms']:.4f}), layout (K2p) "
          f"{r['layout_form_ms']:.4f} ms (b2b {r['layout_form_back_to_back_ms']:.4f})")
    _site_line(f"flash_fwd_reloc {tuple(q3.shape)} x {tuple(k3.shape)} {mask}", r)
    results.append(r)
    del q3, k3, v3, qm, km, vm, ks, vs, out, lse, p_out, p_lse, dense_mask
    check_reloc_edges(randn, ulps)
    for s_ in sites:
        _site_line(f"frame_ctx_packed_fwd[{s_['site']}]", s_)
    torch.cuda.empty_cache()
    return results


def check_reloc_edges(randn, ulps):
    """Phase 2, K1m at the edges of its segment maps: no context, one frame,
    frames shorter than a box (40 frames of 37 rows), whole 256-row frames,
    context and frame tails, frames of 7 rows, whole 128-row segments.
    Each against ``flash_fwd_plain`` with the mask (4 ulps, the lse within
    1e-4) and bit-equal to K2 on the unfolded tensors."""
    import torch

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

    for H, (n_ctx, P, F) in ((16, (0, 1374, 2)), (16, (1525, 1374, 1)), (16, (77, 37, 40)),
                             (16, (610, 256, 3)), (2, (77, 130, 2)), (2, (0, 130, 3)),
                             (2, (128, 128, 2)), (2, (5, 7, 3)), (2, (77, 130, 1))):
        mask = RelocMask(n_ctx, P, F)
        q, k, v = randn(H, mask.nq, 64), randn(H, mask.nk, 64), randn(H, mask.nk, 64)
        out, lse = FA.flash_fwd_reloc(q, k, v, mask)

        def fold(x):  # (H, F * P, 64) -> (F, H, P, 64), frame-major
            return x.view(H, F, P, 64).transpose(0, 1).contiguous()

        k2 = FA.frame_ctx_fwd(fold(q), fold(k[:, n_ctx:]), fold(v[:, n_ctx:]),
                              k[None, :, :n_ctx].contiguous(), v[None, :, :n_ctx].contiguous())
        torch.cuda.synchronize()
        p_out, p_lse = FA.flash_fwd_plain(q, k, v, mask)
        _check(f"flash_fwd_reloc edge ({H}, {mask.nq}, {mask.nk}) {mask}",
               float((out.float() - p_out.float()).abs().max()), ulps(p_out, 4))
        _check(f"flash_fwd_reloc edge {mask} lse", float((lse - p_lse).abs().max()), 1e-4)
        if not torch.equal(fold(out), k2):
            raise AssertionError(f"flash_fwd_reloc edge {mask}: not bit-equal to K2")
    print("  edges: flash_fwd_reloc bit-equal to frame_ctx_fwd (K2) on the unfolded tensors at each")


TRAIN_FRAMES = 2  # frames a scene on the train step (bench.py:bench_train's S)


def check_backward_kernels(randn, ulps):
    """Phase 2, the two B9 kernels (dq; dk/dv) of the Hopper backward body at
    the train step's shapes: the ViT, frame and global sites and the two
    calls of the frame-context split (own frame, and the broadcast context
    with an lse cotangent), and their RelocMask forms at reloc layer 0's
    shape and at the 5-query shape of phase 4's mask-form check. Inputs:
    random q, k, v and do, with o and lse from the forward kernel. Held
    against ``flash_bwd_plain``: bf16 outputs, kernel and plain version
    recompute p and ds in fp32 with other summation orders and round ds, p
    and the result to bf16, so the tolerance is 4 ulps at the largest |grad|
    of each output. A second backward at the global and the 5-query masked
    site must be bit-equal to the first (no atomics). Timed a call and 20
    launches back to back beside the plain backward (all three gradients)
    and the yardstick ``torch.autograd.grad`` through SDPA at the same shape
    (with the materialised boolean mask at the masked sites; its forward run
    once beforehand, so only the backward is timed), whose time the pair
    (dq + dk/dv) is divided by."""
    import torch
    import torch.nn.functional as F

    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

    S, H, d = TRAIN_FRAMES, 16, 64
    P = (IMG // 14) ** 2 + 5
    nc = S * (RANK + 5)
    nc5 = NUM_FRAMES * (RANK + 5)
    # (name, BH, Nq, Nk, with an lse cotangent, mask)
    sites = [("vit", S * H, P, P, False, None),
             ("frame", 2 * S * H, P, P, False, None),
             ("global", H, S * P, S * P, False, None),
             ("split own", S * H, P, P, True, None),
             ("split context", S * H, P, nc, True, None),
             ("reloc layer 0, RelocMask", H, S * P, nc + S * P, False,
              RelocMask(nc, P, S)),
             ("reloc 5 queries, RelocMask", H, NUM_FRAMES * P, nc5 + NUM_FRAMES * P, False,
              RelocMask(nc5, P, NUM_FRAMES))]
    # the Hopper body at the edges of its tiling first: one q row (against
    # three keys: with one key every gradient is 0 up to rounding noise, no
    # scale for an ulp tolerance), ragged q and key tiles on both sides, fewer keys than q rows, a
    # second warpgroup with no row inside nq; with and without dlse
    for bh, nq, nk, with_dlse in ((2, 1, 3, False), (3, 130, 77, True), (2, 257, 130, False),
                                  (1, 200, 333, True), (2, 64, 64, False)):
        q, do, k, v = randn(bh, nq, d), randn(bh, nq, d), randn(bh, nk, d), randn(bh, nk, d)
        o, lse = FA.flash_fwd(q, k, v)
        dlse = randn(bh, nq, dtype=torch.float32) if with_dlse else None
        grads = FA.flash_bwd(q, k, v, o, lse, do, dlse)
        torch.cuda.synchronize()
        refs = FA.flash_bwd_plain(q, k, v, o, lse, do, dlse)
        for label, g, r in zip(("dq", "dk", "dv"), grads, refs):
            _check(f"flash_bwd edge ({bh}, {nq}, {nk}){' dlse' if with_dlse else ''} {label}",
                   float((g.float() - r.float()).abs().max()), ulps(r, 4))
    # the RelocMask forms at the edges of their work tiles: context and frame
    # tails at both kinds of boundary, no context, one-row frames, whole
    # 128-row segments, the train site's 98-key context tail; with and
    # without dlse
    for n_ctx, fs, nf in ((77, 130, 2), (0, 130, 3), (5, 1, 7), (128, 128, 2), (98, 257, 2)):
        mask = RelocMask(n_ctx, fs, nf)
        for with_dlse in (False, True):
            q, do = randn(2, mask.nq, d), randn(2, mask.nq, d)
            k, v = randn(2, mask.nk, d), randn(2, mask.nk, d)
            o, lse = FA.flash_fwd_reloc(q, k, v, mask)
            dlse = randn(2, mask.nq, dtype=torch.float32) if with_dlse else None
            grads = FA.flash_bwd(q, k, v, o, lse, do, dlse, mask)
            torch.cuda.synchronize()
            refs = FA.flash_bwd_plain(q, k, v, o, lse, do, dlse, mask)
            for label, g, r in zip(("dq", "dk", "dv"), grads, refs):
                _check(f"flash_bwd edge {mask}{' dlse' if with_dlse else ''} {label}",
                       float((g.float() - r.float()).abs().max()), ulps(r, 4))
    rows = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    for site, bh, nq, nk, with_dlse, mask in sites:
        q, do = randn(bh, nq, d), randn(bh, nq, d)
        k, v = randn(bh, nk, d), randn(bh, nk, d)
        o, lse = FA.flash_fwd(q, k, v) if mask is None else FA.flash_fwd_reloc(q, k, v, mask)
        dlse = randn(bh, nq, dtype=torch.float32) if with_dlse else None
        grads = FA.flash_bwd(q, k, v, o, lse, do, dlse, mask)
        torch.cuda.synchronize()
        refs = FA.flash_bwd_plain(q, k, v, o, lse, do, dlse, mask)
        errs = {}
        for label, g, r in zip(("dq", "dk", "dv"), grads, refs):
            errs[label] = float((g.float() - r.float()).abs().max())
            _check(f"flash_bwd[{site}] {label} {tuple(g.shape)}", errs[label], ulps(r, 4))
        if site in ("global", "reloc 5 queries, RelocMask"):
            again = FA.flash_bwd(q, k, v, o, lse, do, dlse, mask)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"flash_bwd[{site}]: a second backward is not bit-equal")
            print(f"  flash_bwd[{site}]: a second backward bit-equal to the first")
            del again
        delta = FA._delta(o, do, dlse).contiguous()
        # allowed pairs a head
        pairs = nq * nk if mask is None else nq * (mask.n_ctx + mask.frame_size)
        io = (2 * q.numel() + 2 * k.numel()) * 2 + 2 * lse.numel() * 4
        qm, km, vm = (t.view(1, bh, -1, d).detach().requires_grad_() for t in (q, k, v))
        attn_mask = None if mask is None else mask.materialize("cuda")
        out = F.scaled_dot_product_attention(qm, km, vm, attn_mask=attn_mask)
        dom = do.view(out.shape)
        sdpa_bwd = lambda: torch.autograd.grad(out, (qm, km, vm), dom,  # noqa: E731
                                               retain_graph=True)
        plain = _time_ms(lambda: FA.flash_bwd_plain(q, k, v, o, lse, do, dlse, mask),
                         reps=3, warmup=1)
        common = dict(site=site, shape=[bh, nq, nk, d], plain_ms=plain,
                      library_ms=_time_ms(sdpa_bwd),
                      library_back_to_back_ms=_back_to_back_ms(sdpa_bwd),
                      masked=mask is not None)
        dq_fn = lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, mask)  # noqa: E731
        dkv_fn = lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta, mask)  # noqa: E731
        b_dq, by_dq = _bound_ms(3 * 2.0 * bh * pairs * d, io + q.numel() * 2)
        rows["flash_bwd_dq"].append(dict(
            common, max_abs_err=errs["dq"], bound_ms=b_dq, bound_by=by_dq,
            ms=_time_ms(dq_fn), back_to_back_ms=_back_to_back_ms(dq_fn)))
        b_kv, by_kv = _bound_ms(4 * 2.0 * bh * pairs * d, io + 2 * k.numel() * 2)
        rows["flash_bwd_dkv"].append(dict(
            common, max_abs_err=max(errs["dk"], errs["dv"]), bound_ms=b_kv, bound_by=by_kv,
            ms=_time_ms(dkv_fn), back_to_back_ms=_back_to_back_ms(dkv_fn)))
        del q, k, v, do, o, lse, grads, refs, out, qm, km, vm
        torch.cuda.empty_cache()
    results = []
    for name, line in (("flash_bwd_dq", 332), ("flash_bwd_dkv", 349)):
        ss = rows[name]
        for s_ in ss:
            print(f"  {name}[{s_['site']}] {s_['shape']}: kernel {s_['ms']:.4f} ms, b2b "
                  f"{s_['back_to_back_ms']:.4f} ms, bound {s_['bound_ms']:.4f} ms "
                  f"({s_['bound_by']}, {s_['bound_ms'] / s_['back_to_back_ms']:.3f} of it b2b, "
                  f"{s_['bound_ms'] / s_['back_to_back_ms'] * PEAK_BF16_FLOPS / 1e12:.0f} "
                  f"TFLOP/s), plain backward {s_['plain_ms']:.4f} ms")
        path = [s_ for s_ in ss if not s_["masked"]]
        results.append(dict(
            name=name, route="cuda",
            source="self_supervise_sfm_tpu_torch/csrc/flash_bwd_sm90.cu",
            # the RelocMask form (0 launches on every path), the same body
            masked_source="self_supervise_sfm_tpu_torch/csrc/flash_bwd_sm90.cu",
            replaces=f"self_supervise_sfm_tpu/ops/flash_attention.py:{line}",
            # one call at each unmasked site of the train step; plain_ms and
            # library_ms compute all three gradients
            max_abs_err=max(s_["max_abs_err"] for s_ in ss),
            **{k: sum(s_[k] for s_ in path)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            bound_by=path[-1]["bound_by"], sites=ss))
    # the pair against SDPA's whole backward, a call and back to back
    for a, b in zip(rows["flash_bwd_dq"], rows["flash_bwd_dkv"]):
        call, b2b = a["ms"] + b["ms"], a["back_to_back_ms"] + b["back_to_back_ms"]
        print(f"  flash_bwd pair[{a['site']}]: {call:.4f} ms a call, {b2b:.4f} ms b2b; SDPA "
              f"backward {a['library_ms']:.4f} / {a['library_back_to_back_ms']:.4f} ms; pair / "
              f"SDPA {call / a['library_ms']:.2f} a call, {b2b / a['library_back_to_back_ms']:.2f} "
              f"b2b")
    return results


def kernel_wrappers() -> dict:
    """Every kernel's launch wrapper by its name in the kernel line; each
    counts its launches in ``.launches``."""
    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops import fused_qkv as FQ
    from self_supervise_sfm_tpu_torch.ops import resize as RS

    return {"flash_fwd": FA.flash_fwd, "frame_ctx_fwd": FA.frame_ctx_fwd,
            "frame_ctx_packed_fwd": FA.frame_ctx_packed_fwd,
            "flash_fwd_reloc": FA.flash_fwd_reloc,
            "resize_bilinear": RS.resize_bilinear_fwd,
            "fused_ln_qkv_rope": FQ.fused_ln_qkv_rope_fwd, "fused_ln_qkv": FQ.fused_ln_qkv_fwd,
            "fused_proj_residual": FQ.fused_proj_residual_fwd,
            "fused_mlp_up": FQ.fused_mlp_up, "fused_mlp_down": FQ.fused_mlp_down,
            "flash_bwd_dq": FA.flash_bwd_dq, "flash_bwd_dkv": FA.flash_bwd_dkv}


def run_forward(gen):
    """Phase 3: the full-width forward through the kernels, its launch counts,
    and its agreement with the plain-path forward."""
    import torch

    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M

    wrappers = kernel_wrappers()
    unfused = dict(fused_qkv="off", fused_mlp="off")
    plain_sites = dict(attn_impl="dense", global_attn_impl="dense", resize_impl="einsum",
                       **unfused)
    # the main path: every kernel on; the same with the fused block kernels
    # off (attention and resize kernels only); every site on plain PyTorch
    cfg = M.make_config(compute_dtype="bfloat16")
    cfg_unfused = M.make_config(compute_dtype="bfloat16", **unfused)
    cfg_plain = M.make_config(compute_dtype="bfloat16", **plain_sites)
    cfg_f32 = M.make_config(**plain_sites)
    t0 = time.perf_counter()
    p32 = M.init_sailrecon(cfg, gen, device="cuda")
    params = M.cast_trunk_weights(p32, cfg)
    uniq = torch.rand((1, NUM_FRAMES, IMG, IMG, 3), generator=gen, device="cuda")
    images = torch.cat([uniq, uniq], dim=1)
    torch.cuda.synchronize()
    print(f"  init {time.perf_counter() - t0:.2f} s")

    def draw():
        # the same scene-token subsample for every run compared
        return torch.Generator(device="cuda").manual_seed(SEED + 1)

    def fwd(c, p):
        return M.forward(p, c, images, NUM_FRAMES, NUM_FRAMES, rank=RANK,
                         generator=draw(), images_duplicated=True)

    for w in wrappers.values():
        w.launches = 0
    out = fwd(cfg, params)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"  launches in one forward: {launches}")
    expected = FORWARD_LAUNCHES
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")

    def timed(c, reps):
        """Median forward seconds, all runs, and the peak memory in GB."""
        fwd(c, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fwd(c, params)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        return statistics.median(runs), runs, torch.cuda.max_memory_allocated() / 1e9

    # in turns on the one card: fused, unfused, unfused, fused
    step_a, runs_a, peak_gb = timed(cfg, 3)
    unf_a, unf_runs_a, unfused_peak_gb = timed(cfg_unfused, 3)
    unf_b, unf_runs_b, _ = timed(cfg_unfused, 3)
    step_b, runs_b, _ = timed(cfg, 3)
    times, unfused_times = runs_a + runs_b, unf_runs_a + unf_runs_b
    step, unfused_step = statistics.median(times), statistics.median(unfused_times)

    before = {k: w.launches for k, w in wrappers.items()}
    plain = fwd(cfg_plain, params)
    f32 = fwd(cfg_f32, p32)
    torch.cuda.synchronize()
    if {k: w.launches for k, w in wrappers.items()} != before:
        raise AssertionError("the plain-path forward launched a kernel")
    plain_step, _, plain_peak_gb = timed(cfg_plain, 1)

    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    # the default configuration, fp32 with attn_impl "auto": the attention
    # and fused block kernels take bf16 only, so every site runs dense, as
    # the fp32 plain path does; K3 takes the fp32 heads' final upsample
    cfg_default = M.make_config()
    before = {k: w.launches for k, w in wrappers.items()}
    dflt = fwd(cfg_default, p32)
    torch.cuda.synchronize()
    n_default = {k: w.launches - before[k] for k, w in wrappers.items()}
    print(f"  launches in one forward of the default configuration (fp32, auto): {n_default}")
    want = {**dict.fromkeys(wrappers, 0), "resize_bilinear": launches["resize_bilinear"]}
    if n_default != want:
        raise AssertionError(f"default configuration launch counts {n_default}, "
                             f"expected {want}")

    shapes = {"extrinsic": (1, 5, 3, 4), "intrinsic": (1, 5, 3, 3),
              "point_map": (1, 5, IMG, IMG, 3), "xyz_cnf": (1, 5, IMG, IMG),
              "depth_map": (1, 5, IMG, IMG, 1), "dpt_cnf": (1, 5, IMG, IMG),
              "point_map_by_unprojection": (1, 5, IMG, IMG, 3),
              "cam_tokens": (1, 5, 2048)}
    for k, shape in shapes.items():
        expect(tuple(out[k].shape) == shape, f"{k}: shape {tuple(out[k].shape)}")
        share = float(torch.isfinite(out[k]).float().mean())
        print(f"  {k}: finite share {share:.6f} (kernel path)")

    # trunk (attention and fused block kernels): the kernel path's aggregator
    # output against the plain path's, in relative RMS; the yardstick is what
    # bf16 itself moves the plain path away from an fp32 forward
    def agg(c, p):
        return AG.aggregator_forward(p["aggregator"], c.aggregator, images, NUM_FRAMES,
                                     NUM_FRAMES, RANK, generator=draw(),
                                     images_duplicated=True)

    tk, psi, ck = agg(cfg, params)
    tp, _, cp = agg(cfg_plain, params)
    tf, _, cf = agg(cfg_f32, p32)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    # the default configuration against the fp32 plain path: one route, so
    # agreement to fp32 rounding (rel-RMS 1e-5) in the trunk and the poses;
    # the depth and point maps (K3 against the einsum upsample, both fp32)
    # on the logit scale within phase 3's 1e-3, where both are finite
    td, _, cd = agg(cfg_default, p32)
    same = all(torch.equal(td[li], tf[li]) for li in cfg.aggregator.intermediate_layer_idx)
    for name, a, b in ([(f"tap {li}", td[li], tf[li])
                        for li in cfg.aggregator.intermediate_layer_idx]
                       + [("anchor cam tokens", cd, cf)]
                       + [(k, dflt[k], f32[k]) for k in ("extrinsic", "intrinsic", "cam_tokens")]):
        err = rel(a, b)
        print(f"  default configuration {name}: vs the fp32 plain path rel-RMS {err:.4e} "
              f"(tolerance 1e-5)")
        expect(err <= 1e-5, f"default configuration {name}: {err} over 1e-5")
    print(f"  default configuration trunk taps bit-equal to the fp32 plain path's: {same}")
    for k in ("depth_map", "point_map"):
        ya, yb = _logit(k, dflt[k].float()), _logit(k, f32[k].float())
        both = torch.isfinite(ya) & torch.isfinite(yb)
        err = float(((ya - yb).abs() / yb.abs().clamp(min=1.0))[both].max())
        print(f"  default configuration {k}: max logit error / max(|logit|, 1) {err:.4e} "
              f"(tolerance 1e-3), finite share {float(both.float().mean()):.6f}")
        expect(err <= 1e-3, f"default configuration {k}: {err} over 1e-3")
    del dflt, td, cd

    pairs = [(f"tap {li}", tk[li], tp[li], tf[li])
             for li in cfg.aggregator.intermediate_layer_idx]
    pairs.append(("anchor cam tokens", ck, cp, cf))
    for name, a, b, c in pairs:
        err, env = rel(a, b), rel(b, c)
        print(f"  trunk {name}: kernel vs plain rel-RMS {err:.4e}, plain bf16 vs fp32 "
              f"{env:.4e} (tolerance 2x that)")
        expect(err <= 2 * env, f"trunk {name}: {err} over twice the bf16 envelope {env}")

    # heads (K3): the same taps decoded with the final upsample on the kernel
    # and on the einsum path, compared on the scale of the logits (inverse of
    # the exp / inverse-log activations). With an fp32 store the two differ
    # by fp32 rounding only: tolerance 1e-3 * max(|logit|, 1) per element.
    # With the main path's bf16 store, whole-ulp flips of the stored values
    # move the logits further; that error is printed for the record (phase 2
    # holds the bf16 store itself to one ulp). At random init these heads
    # overflow (and underflow) fp32 on part of the image; the finite masks may
    # differ only at those edges (|logit| within 1 of -log(FLT_MIN)).
    def decode(c, store):
        c = dataclasses.replace(
            c, point=dataclasses.replace(c.point, final_upsample_dtype=store),
            depth=dataclasses.replace(c.depth, final_upsample_dtype=store))
        return M._decode_heads(params, c, tk, ck, (IMG, IMG), psi)

    hk = decode(cfg, "bfloat16")
    for k in ("extrinsic", "intrinsic", "depth_map", "point_map", "cam_tokens"):
        expect(torch.equal(hk[k], out[k]), f"{k}: the forward is not reproducible")
    hp = decode(cfg_plain, "bfloat16")
    hk32, hp32 = decode(cfg, "float32"), decode(cfg_plain, "float32")
    edge = -math.log(torch.finfo(torch.float32).tiny) - 1.0
    for k in ("point_map", "xyz_cnf", "depth_map", "dpt_cnf",
              "point_map_by_unprojection"):
        errs = []
        for ha, hb in ((hk32, hp32), (hk, hp)):
            ya, yb = _logit(k, ha[k].float()), _logit(k, hb[k].float())
            fa, fb = torch.isfinite(ya), torch.isfinite(yb)
            both, flip = fa & fb, fa ^ fb
            at_edge = torch.where(fa, ya, yb).abs() > edge
            if k == "point_map_by_unprojection":
                # a point overflows where its depth does, however small the
                # ray coordinate that scales the other path's finite depth
                at_edge |= torch.minimum(_logit("depth_map", ha["depth_map"].float()),
                                         _logit("depth_map", hb["depth_map"].float())) > edge
            expect(bool(at_edge[flip].all()),
                   f"heads {k}: finite masks differ away from the overflow edge")
            errs.append(float(((ya - yb).abs() / yb.abs().clamp(min=1.0))[both].max()))
        print(f"  heads {k}: K3 vs einsum upsample, max logit error / max(|logit|, 1): "
              f"fp32 store {errs[0]:.4e} (tolerance 1e-3), bf16 store {errs[1]:.4e}; "
              f"finite share {float(torch.isfinite(hk[k]).float().mean()):.6f}")
        expect(errs[0] <= 1e-3, f"heads {k}: {errs[0]} over tolerance")

    # the end-to-end outputs of the two paths, for the record
    for k in ("extrinsic", "intrinsic", "depth_map", "point_map"):
        a, b, c = out[k].float(), plain[k].float(), f32[k].float()
        both = torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
        print(f"  end to end {k}: kernel vs plain max_abs "
              f"{float((a - b)[both].abs().max()):.4e}, plain bf16 vs fp32 "
              f"{float((b - c)[both].abs().max()):.4e}")
    for k in ("extrinsic", "intrinsic", "cam_tokens"):
        expect(bool(torch.isfinite(out[k]).all()), f"{k}: non-finite values")
    if failures:
        raise AssertionError("; ".join(failures))

    # where the time goes: the trunk and the heads alone, then one forward
    # under the profiler, device time grouped by kernel class
    trunk_ms = _wall_ms(lambda: agg(cfg, params))
    heads_ms = _wall_ms(lambda: M._decode_heads(params, cfg, tk, ck, (IMG, IMG), psi))
    print(f"  trunk (aggregator) {trunk_ms:.2f} ms, heads {heads_ms:.2f} ms (median of 3)")
    print("  profile of the main path (every kernel on):")
    breakdown = profile_forward(lambda: fwd(cfg, params))
    print("  profile with the fused block kernels off:")
    unfused_breakdown = profile_forward(lambda: fwd(cfg_unfused, params))
    fps = NUM_FRAMES / step
    for name, sec, gb, n in (("main path (every kernel on)", step, peak_gb, len(times)),
                             ("fused block kernels off", unfused_step, unfused_peak_gb,
                              len(unfused_times)),
                             ("every site on plain PyTorch", plain_step, plain_peak_gb, 1)):
        print(f"  forward, {name}: {sec * 1e3:.2f} ms median of {n} "
              f"({NUM_FRAMES / sec:.3f} frames/s, {NUM_FRAMES} frames of {IMG} px), "
              f"peak memory {gb:.2f} GB")
    state = dict(cfg=cfg, cfg_plain=cfg_plain, cfg_f32=cfg_f32, params=params, p32=p32,
                 uniq=uniq, draw=draw, taps=tk, wrappers=wrappers)
    return launches, state, dict(
        step_ms=step * 1e3, frames_per_s=fps, peak_gb=peak_gb,
        times_ms=[t * 1e3 for t in times],
        unfused_step_ms=unfused_step * 1e3, unfused_frames_per_s=NUM_FRAMES / unfused_step,
        unfused_peak_gb=unfused_peak_gb, unfused_times_ms=[t * 1e3 for t in unfused_times],
        plain_step_ms=plain_step * 1e3, plain_frames_per_s=NUM_FRAMES / plain_step,
        plain_peak_gb=plain_peak_gb,
        trunk_ms=trunk_ms, heads_ms=heads_ms, profile=breakdown,
        unfused_profile=unfused_breakdown)


def run_serving(state):
    """Phase 4: two-phase serving at full width through the kernels: launch
    counts, agreement with the plain path and with the joint forward, timings,
    and the chunked / host-staged variants on a 20-anchor scene."""
    import torch

    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.ops import attention_core as AC
    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

    cfg, cfg_plain, cfg_f32 = state["cfg"], state["cfg_plain"], state["cfg_f32"]
    params, p32, uniq, draw = state["params"], state["p32"], state["uniq"], state["draw"]
    wrappers = state["wrappers"]
    acfg = cfg.aggregator
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: w.launches for k, w in wrappers.items()}

    def build(c, p, images=uniq, **kw):
        # the same scene-token subsample as the joint forward of phase 3
        return M.build_scene_cache(p, c, images, rank=RANK, generator=draw(), **kw)

    # -- 1. launch counts around one build, one reloc, one fast reloc --------
    (cache, cam), n_build = counted(lambda: build(cfg, params))
    out, n_reloc = counted(lambda: M.reloc(params, cfg, cache, cam, uniq))
    fast, n_fast = counted(lambda: M.reloc(params, cfg, cache, cam, uniq, fast_reloc=True))
    print(f"  launches in one build: {n_build}")
    print(f"  launches in one reloc: {n_reloc}")
    want_build, want_fast, want_reloc = BUILD_LAUNCHES, FAST_RELOC_LAUNCHES, RELOC_LAUNCHES
    for name, got, want in (("build", n_build, want_build), ("reloc", n_reloc, want_reloc),
                            ("fast_reloc", n_fast, want_fast)):
        if got != want:
            raise AssertionError(f"{name} launch counts {got}, expected {want}")
    kv = cache["kv"]
    nc = NUM_FRAMES * (RANK + 5)
    expect(tuple(kv.shape) == (24, 1, 16, nc, 128) and kv.dtype == torch.bfloat16
           and kv.is_contiguous(), f"cache {tuple(kv.shape)} {kv.dtype}")
    cache_bytes = kv.numel() * kv.element_size()
    print(f"  cache {tuple(kv.shape)} {kv.dtype}: {cache_bytes / 1e6:.1f} MB, "
          f"{cache_bytes / NUM_FRAMES / 1e6:.2f} MB an anchor")
    for k in ("extrinsic", "intrinsic"):
        expect(bool(torch.isfinite(out[k]).all()), f"reloc {k}: non-finite values")
        expect(torch.equal(fast[k], out[k]), f"fast_reloc {k} differs from reloc's")
    expect(tuple(out["point_map"].shape) == (1, NUM_FRAMES, IMG, IMG, 3)
           and tuple(out["xyz_conf_fractions"].shape) == (1, NUM_FRAMES, 18),
           "reloc output shapes")

    # the mask form of reloc layer 0 on the model's own tensors: sdpa with a
    # RelocMask (the masked flash kernel) against the in-place layout form
    def mask_form():
        tokens, t_frame = AG._reloc_setup(params["aggregator"], acfg, uniq)
        B, Q, Ptok, C = tokens.shape
        fp, rp = (params["aggregator"][k][0] for k in ("frame_blocks", "reloc_blocks"))
        t = AG.block(fp, tokens.reshape(B * Q, Ptok, C), acfg.block_cfg, t_frame)
        q, k, v = AG.qkv_parts(rp, t, acfg.block_cfg, t_frame)
        layout = FA.packed_ctx_attention(q, k, v, kv, 0)

        def unfold(x):
            return x.transpose(0, 1).reshape(1, x.shape[1], Q * Ptok, x.shape[3])

        ck, cv = kv[0, ..., :64], kv[0, ..., 64:]
        masked = AC.sdpa(unfold(q), torch.cat([ck, unfold(k)], dim=2),
                         torch.cat([cv, unfold(v)], dim=2),
                         mask=RelocMask(nc, Ptok, Q), impl="auto")
        return unfold(layout), masked

    (layout, masked), n_mask = counted(mask_form)
    if n_mask["flash_fwd_reloc"] != 1 or n_mask["frame_ctx_packed_fwd"] != 1:
        raise AssertionError(f"mask form launch counts {n_mask}")
    err = float((layout.float() - masked.float()).abs().max())
    tol = 4 * 2.0 ** (math.floor(math.log2(float(layout.abs().max()))) - 7)
    _check("reloc layer 0, mask form (K1m) vs layout form (K2p)", err, tol)
    # one body, one walk: the two forms agree bit for bit
    expect(torch.equal(layout, masked), "reloc layer 0: mask form not bit-equal to layout form")
    print(f"  reloc layer 0, mask form bit-equal to layout form: {torch.equal(layout, masked)}")

    # -- 2. agreement with the plain path and with the joint forward ---------
    before = {k: w.launches for k, w in wrappers.items()}
    cache_p, cam_p = build(cfg_plain, params)
    cache_f, cam_f = build(cfg_f32, p32)

    def taps_of(c, p, ca):
        return AG.aggregator_reloc(p["aggregator"], c.aggregator, ca, uniq)[0]

    tp, tf = taps_of(cfg_plain, params, cache_p), taps_of(cfg_f32, p32, cache_f)
    torch.cuda.synchronize()
    if {k: w.launches for k, w in wrappers.items()} != before:
        raise AssertionError("the plain-path build / reloc launched a kernel")
    tk = taps_of(cfg, params, cache)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    pairs = [("scene cache", kv, cache_p["kv"], cache_f["kv"]),
             ("anchor cam tokens", cam, cam_p, cam_f)]
    pairs += [(f"reloc tap {li}", tk[li], tp[li], tf[li])
              for li in acfg.intermediate_layer_idx]
    envelope = {}
    for name, a, b, c in pairs:
        err, env = rel(a, b), rel(b, c)
        envelope[name] = env
        print(f"  {name}: kernel vs plain rel-RMS {err:.4e}, plain bf16 vs fp32 "
              f"{env:.4e} (tolerance 2x that)")
        expect(err <= 2 * env, f"{name}: {err} over twice the bf16 envelope {env}")
    # the identity the design rests on: reloc against the cache is the joint
    # forward's query half (same math, another program)
    for li in acfg.intermediate_layer_idx:
        err, env = rel(tk[li], state["taps"][li]), envelope[f"reloc tap {li}"]
        same = torch.equal(tk[li], state["taps"][li])
        print(f"  reloc tap {li} vs the joint forward's: rel-RMS {err:.4e} "
              f"({'bit-equal' if same else 'not bit-equal'}; tolerance 2x {env:.4e})")
        expect(err <= 2 * env, f"reloc tap {li} vs joint forward: {err} over 2x {env}")
    del cache_p, cache_f, tp, tf, state["taps"]
    torch.cuda.empty_cache()

    # -- 3. timings at 5 anchors / 5 queries ----------------------------------
    def timed(fn, reps=5):
        """Median seconds, all runs, and the peak memory in GB over them."""
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        return statistics.median(runs), runs, torch.cuda.max_memory_allocated() / 1e9

    res = {"cache_bytes": cache_bytes, "cache_bytes_per_anchor": cache_bytes / NUM_FRAMES}
    held_gb = torch.cuda.memory_allocated() / 1e9  # weights of both dtypes, cache, images
    res["held_gb"] = held_gb
    t, runs, peak = timed(lambda: build(cfg, params))
    res.update(build_ms=t * 1e3, build_runs_ms=[r * 1e3 for r in runs], build_peak_gb=peak)
    t, runs, peak = timed(lambda: M.reloc(params, cfg, cache, cam, uniq))
    res.update(reloc_ms=t * 1e3, reloc_runs_ms=[r * 1e3 for r in runs],
               reloc_frames_per_s=NUM_FRAMES / t, reloc_peak_gb=peak)
    t, runs, peak = timed(lambda: M.reloc(params, cfg, cache, cam, uniq, fast_reloc=True))
    res.update(fast_reloc_ms=t * 1e3, fast_reloc_runs_ms=[r * 1e3 for r in runs],
               fast_reloc_frames_per_s=NUM_FRAMES / t, fast_reloc_peak_gb=peak)
    print(f"  5 anchors: warm build {res['build_ms']:.2f} ms (peak {res['build_peak_gb']:.2f} "
          f"GB); reloc of 5 queries, full heads {res['reloc_ms']:.2f} ms "
          f"({res['reloc_frames_per_s']:.3f} frames/s, peak {res['reloc_peak_gb']:.2f} GB); "
          f"fast_reloc {res['fast_reloc_ms']:.2f} ms "
          f"({res['fast_reloc_frames_per_s']:.3f} frames/s, peak "
          f"{res['fast_reloc_peak_gb']:.2f} GB); {held_gb:.2f} GB held before each "
          f"(fp32 and bf16 weights, cache, images); medians of 5")
    print("  profile of one build (5 anchors):")
    res["build_profile"] = profile_forward(lambda: build(cfg, params))
    print("  profile of one fast_reloc (5 queries):")
    res["fast_reloc_profile"] = profile_forward(
        lambda: M.reloc(params, cfg, cache, cam, uniq, fast_reloc=True))
    print("  profile of one reloc with full heads (5 queries):")
    res["reloc_profile"] = profile_forward(lambda: M.reloc(params, cfg, cache, cam, uniq))
    del cache, out, fast

    # -- 4. a 20-anchor scene: the five images tiled, each copy perturbed -----
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    scene = uniq.repeat(1, 4, 1, 1, 1)
    scene = (scene + 0.02 * torch.randn(scene.shape, generator=g, device="cuda")).clamp(0, 1)
    A20 = scene.shape[1]
    big, cam_big = build(cfg, params, scene)
    nbytes = big["kv"].numel() * big["kv"].element_size()
    expect(tuple(big["kv"].shape) == (24, 1, 16, A20 * (RANK + 5), 128), "20-anchor cache shape")
    print(f"  20 anchors: cache {tuple(big['kv'].shape)}, {nbytes / 1e9:.3f} GB")
    # anchor-chunked builds against the one-shot build. The fused kernels and
    # the flash kernel work row by row, so chunking the rows changes no value
    # of theirs; the library matmuls of the unfused context K/V and the ViT's
    # patch convolution may pick another summation order for another row
    # count. Tolerance: twice the bf16-vs-fp32 envelope of the cache above.
    for label, kw in (("anchor_chunk=5", dict(anchor_chunk=5)),
                      ("anchor_chunk=5, chunk_embed=False",
                       dict(anchor_chunk=5, chunk_embed=False))):
        ch, cam_ch = build(cfg, params, scene, **kw)
        same = torch.equal(ch["kv"], big["kv"]) and torch.equal(cam_ch, cam_big)
        err = rel(ch["kv"], big["kv"])
        print(f"  {label} build vs one-shot: {'bit-equal' if same else 'not bit-equal'}, "
              f"cache rel-RMS {err:.4e}, max abs "
              f"{float((ch['kv'].float() - big['kv'].float()).abs().max()):.4e} "
              f"(tolerance 2x {envelope['scene cache']:.4e})")
        expect(err <= 2 * envelope["scene cache"], f"{label} build: {err} over tolerance")
        del ch
    # host-staged build into pinned memory; staged reloc against it
    host, cam_host = M.build_scene_cache_staged(params, cfg, scene, rank=RANK,
                                                generator=draw(), num_segments=4)
    expect(host["kv"].device.type == "cpu" and host["kv"].is_pinned(),
           "the staged cache is not in pinned host memory")
    expect(torch.equal(host["kv"], big["kv"].cpu()) and torch.equal(cam_host, cam_big.cpu()),
           "staged build differs from the one-shot build")
    t_res = AG.aggregator_reloc(params["aggregator"], acfg, big, uniq)[0]
    t_st = AG.aggregator_reloc_staged(params["aggregator"], acfg, host, uniq, 4)[0]
    same = all(torch.equal(t_res[li], t_st[li]) for li in acfg.intermediate_layer_idx)
    print(f"  staged build == one-shot build, reloc_staged taps == resident reloc taps: "
          f"{'bit-equal' if same else 'NOT bit-equal'}")
    expect(same, "reloc_staged taps are not bit-equal to the resident reloc's")
    full = M.reloc(params, cfg, big, cam_big, uniq)
    staged = M.reloc_staged(params, cfg, host, cam_host, uniq, num_segments=4)
    chunked = M.reloc_chunked(params, cfg, big, cam_big, uniq, chunk=2)
    for k in ("extrinsic", "intrinsic", "cam_tokens", "depth_map"):
        expect(torch.equal(staged[k], full[k]), f"reloc_staged {k} differs from reloc's")
    # chunks of 2 frames (the last one padded): the trunk kernels work frame
    # by frame, so the camera tokens must not move. cuDNN may pick another
    # algorithm for a head convolution at batch 2: with the final upsample
    # stored in fp32 that is fp32 rounding, held on the logit scale to the
    # tolerance of phase 3's head check; with the path's bf16 store a value
    # may round to its neighbour, and that error is printed for the record.
    same = torch.equal(chunked["cam_tokens"], full["cam_tokens"])
    cfg32 = dataclasses.replace(
        cfg, point=dataclasses.replace(cfg.point, final_upsample_dtype="float32"),
        depth=dataclasses.replace(cfg.depth, final_upsample_dtype="float32"))
    errs = []
    for a, b in ((M.reloc_chunked(params, cfg32, big, cam_big, uniq, chunk=2),
                  M.reloc(params, cfg32, big, cam_big, uniq)), (chunked, full)):
        ya, yb = _logit("depth_map", a["depth_map"]), _logit("depth_map", b["depth_map"])
        both = torch.isfinite(ya) & torch.isfinite(yb)
        errs.append(float(((ya - yb).abs() / yb.abs().clamp(min=1.0))[both].max()))
    del a, b
    print(f"  reloc_chunked(chunk=2) vs reloc: cam tokens "
          f"{'bit-equal' if same else 'not bit-equal'} (rel-RMS "
          f"{rel(chunked['cam_tokens'], full['cam_tokens']):.4e}), depth logits max error "
          f"fp32 store {errs[0]:.4e} (tolerance 1e-3), bf16 store {errs[1]:.4e}")
    expect(rel(chunked["cam_tokens"], full["cam_tokens"]) <= 2 * envelope["reloc tap 23"],
           "reloc_chunked cam tokens over tolerance")
    expect(tuple(chunked["point_map"].shape) == tuple(full["point_map"].shape)
           and errs[0] <= 1e-3, f"reloc_chunked depth: {errs[0]}")
    del full, staged, chunked, t_res, t_st
    torch.cuda.empty_cache()

    big_res = {"anchors": A20, "cache_bytes": nbytes}
    for name, fn in (
        ("build", lambda: build(cfg, params, scene)),
        ("build_chunk5", lambda: build(cfg, params, scene, anchor_chunk=5)),
        ("build_staged4", lambda: M.build_scene_cache_staged(
            params, cfg, scene, rank=RANK, generator=draw(), num_segments=4)),
        ("build_staged4_chunk5", lambda: M.build_scene_cache_staged(
            params, cfg, scene, rank=RANK, generator=draw(), num_segments=4,
            anchor_chunk=5)),
        ("fast_reloc", lambda: M.reloc(params, cfg, big, cam_big, uniq, fast_reloc=True)),
        ("fast_reloc_staged4", lambda: M.reloc_staged(
            params, cfg, host, cam_host, uniq, num_segments=4, fast_reloc=True)),
        ("reloc", lambda: M.reloc(params, cfg, big, cam_big, uniq)),
        ("reloc_chunked2", lambda: M.reloc_chunked(params, cfg, big, cam_big, uniq, chunk=2)),
    ):
        t, runs, peak = timed(fn, reps=3)
        big_res[name] = dict(ms=t * 1e3, runs_ms=[r * 1e3 for r in runs], peak_gb=peak)
        print(f"  20 anchors, {name}: {t * 1e3:.2f} ms median of 3, peak {peak:.2f} GB")
    # one segment's copies alone: device -> pinned host and back
    seg = big["kv"][:6]
    pinned = torch.empty(seg.shape, dtype=seg.dtype, pin_memory=True)
    d2h = _time_ms(lambda: pinned.copy_(seg, non_blocking=True), reps=5)
    h2d = _time_ms(lambda: pinned.to("cuda", non_blocking=True), reps=5)
    seg_bytes = seg.numel() * seg.element_size()
    big_res.update(segment_bytes=seg_bytes, segment_d2h_ms=d2h, segment_h2d_ms=h2d)
    print(f"  one segment of 6 layers, {seg_bytes / 1e6:.1f} MB: to pinned host {d2h:.3f} ms "
          f"({seg_bytes / d2h / 1e6:.1f} GB/s), back {h2d:.3f} ms "
          f"({seg_bytes / h2d / 1e6:.1f} GB/s); staged build - one-shot build = "
          f"{big_res['build_staged4']['ms'] - big_res['build']['ms']:.2f} ms for 4 copies "
          f"out, staged fast_reloc - resident = "
          f"{big_res['fast_reloc_staged4']['ms'] - big_res['fast_reloc']['ms']:.2f} ms for 4 "
          f"copies in")
    res["scene20"] = big_res
    if failures:
        raise AssertionError("; ".join(failures))
    return {"build": n_build, "reloc": n_reloc, "mask_form": n_mask}, res


def make_train_batch():
    """One scene in the ``IMC2021Scenes`` / ``stack_scenes`` layout: 2 random
    frames of 518 px and 2 pairs (0 -> 1, 1 -> 0) of 10 000
    correspondences each, made with numpy from SEED + 7. The correspondences
    come from known poses and depths in a 640 x 480 original image (focal
    500 px): source pixels and depths (2-8 units) drawn at random, mapped
    through the two poses into the other camera, so the ground truth
    reprojects them exactly."""
    import numpy as np

    rng = np.random.default_rng(SEED + 7)
    S, K, W0, H0 = TRAIN_FRAMES, 10_000, 640, 480
    Kgt = np.array([[500.0, 0.0, W0 / 2], [0.0, 500.0, H0 / 2], [0.0, 0.0, 1.0]])
    a = 0.1  # the second camera: 0.1 rad about y, then a 0.3 / 0.05 shift
    R = [np.eye(3), np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])]
    t = [np.zeros(3), np.array([0.3, 0.0, 0.05])]
    coords, depths = {"src": [], "dst": []}, {"src": [], "dst": []}
    for s_, d_ in ((0, 1), (1, 0)):
        uv = rng.uniform((0.0, 0.0), (W0, H0), size=(K, 2))
        z = rng.uniform(2.0, 8.0, size=K)
        cam = (np.c_[uv, np.ones(K)] @ np.linalg.inv(Kgt).T) * z[:, None]
        world = (cam - t[s_]) @ R[s_]  # R^T (x - t), row vectors
        cam_d = world @ R[d_].T + t[d_]
        proj = cam_d @ Kgt.T
        coords["src"].append(uv)
        coords["dst"].append(proj[:, :2] / proj[:, 2:])
        depths["src"].append(z)
        depths["dst"].append(cam_d[:, 2])
    f32 = np.float32
    batch = {
        "images": rng.uniform(size=(1, S, IMG, IMG, 3)).astype(f32),
        "K_prime_to_K": np.broadcast_to(np.diag([W0 / IMG, H0 / IMG, 1.0]),
                                        (1, S, 3, 3)).astype(f32),
        "src_idx": np.array([[0, 1]], np.int32), "dst_idx": np.array([[1, 0]], np.int32),
        "src_coords": np.stack(coords["src"])[None].astype(f32),
        "dst_coords": np.stack(coords["dst"])[None].astype(f32),
        "src_depth": np.stack(depths["src"])[None].astype(f32),
        "dst_depth": np.stack(depths["dst"])[None].astype(f32),
        "pair_valid": np.ones((1, 2), f32),
    }
    extr = np.stack([np.c_[R[i], t[i]] for i in range(S)]).astype(f32)
    intr = np.linalg.inv(batch["K_prime_to_K"][0]) @ Kgt
    return batch, extr, intr.astype(f32)


def run_train():
    """Phase 5: the self-supervised train step at full width (ViT-L/14 and
    24 aggregator layers, 518 px, 2 frames a scene duplicated as anchors and
    queries, rank 300, bf16 trunk on fp32 masters, fp32 camera head, Adam
    with a bf16 first moment, each aggregator layer rematerialised:
    ``bench.py:bench_train``'s configuration at the full depth that it cut
    to 12 for a 16 GB TPU). Launch counts of one step against the code's
    prediction, four steps (the first at learning rate 0), finite losses and
    gradient norms, the untouched DPT heads, and the gradients against the
    plain path's (dense attention, fused kernels off) within twice the
    bf16-vs-fp32 envelope the plain path measures; then times, peak memory
    and a profile of one step."""
    import torch

    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.train import loop as L
    from self_supervise_sfm_tpu_torch.train import loss as LS

    wrappers = kernel_wrappers()
    plain_sites = dict(attn_impl="dense", global_attn_impl="dense", fused_qkv="off",
                       fused_mlp="off")
    cfg = M.make_config(compute_dtype="bfloat16", remat=True)
    cfg_plain = M.make_config(compute_dtype="bfloat16", remat=True, **plain_sites)
    cfg_f32 = M.make_config(remat=True, **plain_sites)
    tcfg = L.TrainConfig(rank=RANK, num_images=TRAIN_FRAMES, adam_mu_dtype="bfloat16",
                         warmup_steps=1)
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    t0 = time.perf_counter()
    state = L.init_train_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 7))
    params = state["params"]
    # conditioned as the JAX package's golden loss test conditions its
    # reference model (tests/test_train_step.py): a small pose-branch output
    # whose bias sums to a unit quaternion and 1 rad fields of view over the
    # 4 iterations, so the residuals start inside the CDF's range
    fc2 = params["camera_head"]["pose_branch"]["fc2"]
    fc2["w"].mul_(0.01)
    fc2["b"].mul_(0.01)
    fc2["b"][[3, 7, 8]] = 0.25
    n_params = sum(t.numel() for t in L._flatten(params))
    n_trained = sum(t.numel() for k in ("aggregator", "camera_head")
                    for t in L._flatten(params[k]))
    heads0 = [t.clone() for k in ("depth_head", "point_head") for t in L._flatten(params[k])]
    # a sample of trained leaves, to see whether a step moved them
    sample = lambda: [params["aggregator"]["vit"]["blocks"][0]["attn"]["qkv"]["w"],  # noqa: E731
                      params["aggregator"]["global_blocks"][-1]["mlp"]["fc2"]["w"],
                      params["camera_head"]["pose_branch"]["fc2"]["w"]]
    batch_np, extr_gt, intr_gt = make_train_batch()
    batch = L.batch_to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    print(f"  init {time.perf_counter() - t0:.2f} s: {n_params / 1e6:.1f} M parameters, "
          f"{n_trained / 1e6:.1f} M trained (the DPT heads are not in the loss)")
    # the batch's ground truth reprojects its correspondences exactly
    scene = {k: v[0] for k, v in batch.items() if k != "images"}
    gt = LS.scene_residuals(torch.from_numpy(extr_gt).cuda(), torch.from_numpy(intr_gt).cuda(),
                            scene, tcfg.loss)
    gt_max = float(torch.maximum(gt["residuals"].max(), gt["residuals_approx"].max()))
    print(f"  batch: 2 pairs x 10000 correspondences; ground-truth residual max {gt_max:.3e} px")
    expect(gt_max < 1e-2, f"ground-truth residuals up to {gt_max} px")

    P0 = (IMG // 14) ** 2

    def indices(i):
        g = torch.Generator(device="cuda").manual_seed(SEED + 8 + i)
        return AG.draw_subsample_indices(cfg.aggregator, 1, TRAIN_FRAMES, P0, RANK, g)

    step = L.make_train_step(cfg, tcfg)
    before = [t.clone() for t in sample()]
    for w in wrappers.values():
        w.launches = 0
    state, m0 = step(state, batch, indices(0))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"  launches in one step: {launches}")
    # d aggregator layers, v ViT blocks, remat on the aggregator layers:
    # forwards v + 2d flash (+ 2d recomputed + 2d in the frame-context
    # split's backward), d frame-context (+ d recomputed), 3d fused block
    # kernels of each kind (+ 3d recomputed) and v more of the ViT's;
    # backwards: one B9 pair a flash attention, two a frame-context split
    d, v = 24, 24
    want = {**dict.fromkeys(wrappers, 0), "flash_fwd": v + 6 * d, "frame_ctx_fwd": 2 * d,
            "fused_ln_qkv": v, "fused_ln_qkv_rope": 6 * d, "fused_proj_residual": v + 6 * d,
            "fused_mlp_up": v + 6 * d, "fused_mlp_down": v + 6 * d,
            "flash_bwd_dq": v + 4 * d, "flash_bwd_dkv": v + 4 * d}
    if launches != want:
        raise AssertionError(f"train step launch counts {launches}, expected {want}")
    lr0 = float(m0["learning_rate"])
    expect(lr0 == 0.0 and all(torch.equal(a, b) for a, b in zip(before, sample())),
           f"step 0 (learning rate {lr0}) moved the parameters")

    metrics, times = [m0], []
    torch.cuda.reset_peak_memory_stats()
    for i in (1, 2, 3):
        before = [t.clone() for t in sample()]
        t0 = time.perf_counter()
        state, m = step(state, batch, indices(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append(m)
        if i == 1:
            expect(all(not torch.equal(a, b) for a, b in zip(before, sample())),
                   "step 1 (learning rate > 0) left a sampled parameter unchanged")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    keys = ("loss", "loss_cdf_exact", "loss_cdf_approx", "mean_log_residual",
            "log_residual_p50", "grad_norm", "grad_norm_vit", "grad_norm_agg",
            "grad_norm_camera", "learning_rate")
    for i, m in enumerate(metrics):
        vals = {k: float(m[k]) for k in m}
        print(f"  step {i}: " + ", ".join(f"{k} {vals[k]:.6g}" for k in keys))
        expect(all(math.isfinite(x) for x in vals.values()), f"step {i}: non-finite metrics")
        for k in ("grad_norm_vit", "grad_norm_agg", "grad_norm_camera"):
            expect(vals[k] > 0, f"step {i}: {k} = {vals[k]}")
        expect(vals["grad_norm_depth"] == 0 and vals["grad_norm_point"] == 0,
               f"step {i}: nonzero DPT head gradient norms")
    heads = [t for k in ("depth_head", "point_head") for t in L._flatten(params[k])]
    expect(all(torch.equal(a, b) for a, b in zip(heads0, heads)), "a DPT head changed")
    del heads0, heads

    # gradients of the kernel path against the plain path, same state and
    # subsample; the envelope is what bf16 moves the plain path from fp32
    idx = indices(99)
    for w in wrappers.values():
        w.launches = 0
    loss_k, _, gk = L.loss_and_grads(params, cfg, tcfg, batch, idx)
    loss_p, _, gp = L.loss_and_grads(params, cfg_plain, tcfg, batch, idx)
    loss_f, _, gf = L.loss_and_grads(params, cfg_f32, tcfg, batch, idx)
    torch.cuda.synchronize()
    n_kernel = sum(w.launches for w in wrappers.values())
    print(f"  loss: kernel path {float(loss_k):.6f}, plain {float(loss_p):.6f}, "
          f"plain fp32 {float(loss_f):.6f}")
    subsystems = {
        "vit": lambda g: L._flatten(g["aggregator"]["vit"]),
        "agg": lambda g: L._flatten({k: x for k, x in g["aggregator"].items() if k != "vit"}),
        "camera": lambda g: L._flatten(g["camera_head"]),
    }

    def rel(a, b):
        num = sum(float((x.float() - y.float()).pow(2).sum()) for x, y in zip(a, b))
        return math.sqrt(num) / float(L.global_norm(b))

    grads = {}
    for name, part in subsystems.items():
        a, b, c = part(gk), part(gp), part(gf)
        err, env = rel(a, b), rel(b, c)
        na, nb = float(L.global_norm(a)), float(L.global_norm(b))
        norm_err = abs(na - nb) / nb
        grads[name] = dict(rel_rms=err, envelope=env, norm_kernel=na, norm_plain=nb,
                           norm_rel_err=norm_err)
        print(f"  gradient {name}: kernel vs plain rel-RMS {err:.4e}, norm {na:.6g} vs "
              f"{nb:.6g} (rel {norm_err:.4e}); plain bf16 vs fp32 {env:.4e} "
              f"(tolerance 2x that)")
        expect(err <= 2 * env, f"gradient {name}: {err} over twice the envelope {env}")
        expect(norm_err <= 2 * env, f"gradient norm {name}: {norm_err} over twice {env}")
    del gk, gp, gf

    # remat: nothing on the kernel path sums with atomics but the loss's
    # histograms (index_add_); the gradients with the layers rematerialised,
    # again, and held, for the record
    cfg_held = M.make_config(compute_dtype="bfloat16", remat=False)
    runs = [L.loss_and_grads(params, c, tcfg, batch, idx)[2]
            for c in (cfg, cfg, cfg_held)]
    flat = [L._flatten(g) for g in runs]

    def equal_share(a, b):
        return sum(bool(torch.equal(x, y)) for x, y in zip(a, b)) / len(a)

    remat = dict(repeat_bit_equal_share=equal_share(flat[0], flat[1]),
                 held_bit_equal_share=equal_share(flat[0], flat[2]),
                 held_rel_rms=rel(flat[0], flat[2]))
    print(f"  remat: leaves bit-equal between two remat runs {remat['repeat_bit_equal_share']:.4f}, "
          f"remat vs held {remat['held_bit_equal_share']:.4f} (rel-RMS "
          f"{remat['held_rel_rms']:.3e})")
    del runs, flat
    if failures:
        raise AssertionError("; ".join(failures))

    step_s = statistics.median(times)
    print("  profile of one train step (every kernel on):")
    profile = profile_forward(lambda: step(state, batch, indices(4)), label="train step")
    b9 = None
    if profile["measured"]:
        b9 = {k: profile["classes_ms"][k] for k in ("flash_bwd_dq (B9)", "flash_bwd_dkv (B9)")}
        print(f"  B9 device ms a step: dq {b9['flash_bwd_dq (B9)']:.2f}, dk/dv "
              f"{b9['flash_bwd_dkv (B9)']:.2f}, both {sum(b9.values()):.2f} (of device busy "
              f"{profile['busy_ms']:.2f})")
    print(f"  train step: {step_s * 1e3:.2f} ms median of {len(times)} "
          f"({[round(t * 1e3, 2) for t in times]}), {1 / step_s:.4f} steps/s, "
          f"peak memory {peak_gb:.2f} GB")
    return launches, dict(
        step_ms=step_s * 1e3, steps_per_s=1 / step_s, times_ms=[t * 1e3 for t in times],
        peak_gb=peak_gb, params_m=n_params / 1e6, trained_m=n_trained / 1e6,
        kernel_launches_gradient_eval=n_kernel,
        metrics=[{k: float(x) for k, x in m.items()} for m in metrics],
        gradients=grads, remat=remat, loss_kernel=float(loss_k), loss_plain=float(loss_p),
        loss_f32=float(loss_f), profile=profile, b9_device_ms=b9)


class SyntheticScenes:
    """IMC2021-layout scenes made with numpy alone, so that phase 6 needs no
    ``h5py`` (the HDF5 fixture of ``data/synthetic.py`` does): the trainer
    takes this object in place of a data directory (``__len__`` and
    ``load_scene(idx, rng)``). Scene ``idx``: ``num_images`` cameras on a
    ring looking at a textured slanted plane ~5 units away, each frame a 640
    x 480 original (focal 500 px) rendered straight to the processed
    ``img_size`` (padded to square and resized, as ``K_to_K_prime`` maps
    it); every ordered pair gets ``sample_num`` correspondences drawn from
    ``rng`` among the source pixels that land inside the destination frame,
    with both depths, exact by construction."""

    W0, H0, FOCAL = 640, 480, 500.0

    def __init__(self, num_scenes: int, num_images: int, sample_num: int, img_size: int,
                 seed: int, checker: bool = False):
        self.num_scenes, self.num_images = num_scenes, num_images
        self.sample_num, self.img_size, self.seed = sample_num, img_size, seed
        # a fine checkerboard on the plane (squares of ~4.5 px at 518 px):
        # thousands of corners for the keypoint detector, as a photograph has
        self.checker = checker
        self._frames = {}  # idx -> rendered frames (they do not depend on rng)

    def __len__(self) -> int:
        return self.num_scenes

    def _geometry(self, idx: int):
        import numpy as np

        g = np.random.default_rng((self.seed, idx))
        n = np.array([g.uniform(-0.15, 0.15), g.uniform(-0.15, 0.15), 1.0])
        plane = (n / np.linalg.norm(n), -g.uniform(4.5, 5.5))
        tex = g.uniform([1.0, 0.7, 0.0], [3.0, 2.8, 6.28], size=(3, 3))
        poses = []
        for i in range(self.num_images):
            a = 2 * np.pi * i / self.num_images
            eye = np.array([0.5 * np.cos(a), 0.4 * np.sin(a), g.uniform(-0.2, 0.2)])
            z = np.array([0.3 * np.sin(a), 0.2 * np.cos(a), 5.0]) - eye
            z /= np.linalg.norm(z)
            x = np.cross(z, [0.0, -1.0, 0.0])
            x /= np.linalg.norm(x)
            R = np.stack([x, np.cross(z, x), z])
            poses.append(np.c_[R, -R @ eye])
        return plane, tex, np.stack(poses)

    def _hit(self, pose, plane, uv):
        """World points and camera depths where the rays of original-image
        pixels ``uv`` (N, 2) meet the plane."""
        import numpy as np

        R, t = pose[:, :3], pose[:, 3]
        d_cam = np.c_[(uv - [self.W0 / 2, self.H0 / 2]) / self.FOCAL, np.ones(len(uv))]
        origin, d = -R.T @ t, d_cam @ R
        n, c = plane
        s = -(origin @ n + c) / (d @ n)
        return origin + d * s[:, None], s  # depth = s (d_cam has z = 1)

    def _project(self, pose, pts):
        import numpy as np

        cam = pts @ pose[:, :3].T + pose[:, 3]
        K = [[self.FOCAL, 0, self.W0 / 2], [0, self.FOCAL, self.H0 / 2], [0, 0, 1]]
        pix = cam @ np.asarray(K).T
        return pix[:, :2] / pix[:, 2:], cam[:, 2]

    def processed_K(self):
        """The intrinsics in the processed ``img_size`` frame (K_to_K_prime
        @ K_gt)."""
        import numpy as np

        scale = self.img_size / self.W0
        pad = (self.W0 - self.H0) / 2 * scale
        return np.array([[scale * self.FOCAL, 0, scale * self.W0 / 2],
                         [0, scale * self.FOCAL, scale * self.H0 / 2 + pad], [0, 0, 1]])

    def known_tracks(self, idx: int, num_tracks: int, noise_px: float, rng):
        """Tracks of known geometry: plane points seen from camera 0 projected
        into every frame with the true poses and the processed K, plus
        ``noise_px`` Gaussian noise. Returns (tracks (S, N, 2) fp32,
        visibility (S, N), true w2c (S, 3, 4), K (3, 3)); a frame sees a
        point that lands inside it in front of the camera."""
        import numpy as np

        plane, _, poses = self._geometry(idx)
        uv = rng.uniform((0, 0), (self.W0, self.H0), size=(num_tracks, 2))
        pts, _ = self._hit(poses[0], plane, uv)
        K = self.processed_K()
        cam = np.einsum("sij,nj->sni", poses[:, :, :3], pts) + poses[:, None, :, 3]
        pix = np.einsum("ij,snj->sni", K, cam)
        xy = pix[..., :2] / pix[..., 2:]
        vis = ((cam[..., 2] > 0) & (xy >= 0).all(-1) & (xy < self.img_size).all(-1))
        tracks = xy + rng.normal(scale=noise_px, size=xy.shape)
        return tracks.astype(np.float32), vis, poses.astype(np.float32), K

    def load_scene(self, idx: int, rng) -> dict:
        import numpy as np

        plane, tex, poses = self._geometry(idx)
        T, S, N = self.img_size, self.num_images, self.sample_num
        scale = T / self.W0
        pad = (self.W0 - self.H0) / 2 * scale  # the original sits centred in the square
        k2kp = np.array([[scale, 0, 0], [0, scale, pad], [0, 0, 1]], np.float32)
        kp2k = np.linalg.inv(k2kp).astype(np.float32)
        Kgt = np.array([[self.FOCAL, 0, self.W0 / 2], [0, self.FOCAL, self.H0 / 2], [0, 0, 1]],
                       np.float32)
        if idx not in self._frames:
            vv, uu = np.mgrid[0:T, 0:T].astype(np.float64)
            uv = np.c_[uu.ravel(), vv.ravel()] / scale - [0, pad / scale]
            inside = ((uv[:, 0] >= 0) & (uv[:, 0] < self.W0) & (uv[:, 1] >= 0)
                      & (uv[:, 1] < self.H0))
            images, depths = [], []
            for pose in poses:
                pts, depth = self._hit(pose, plane, uv)
                u, v = pts[:, 0] + 0.5 * pts[:, 2], pts[:, 1] - 0.3 * pts[:, 2]
                rgb = np.stack([0.5 + 0.5 * np.sin(f * u + p) * np.cos(g_ * v)
                                for f, g_, p in tex], -1)
                if self.checker:
                    rgb *= 0.55 + 0.45 * (np.sin(60 * u) * np.sin(60 * v) > 0)[:, None]
                images.append(np.where(inside[:, None], rgb, 0.0).reshape(T, T, 3))
                depths.append(np.where(inside, depth, 0.0).reshape(T, T))
            self._frames[idx] = (np.stack(images).astype(np.float32),
                                 np.stack(depths).astype(np.float32))
        images, depths = self._frames[idx]
        pairs = [(i, j) for i in range(S) for j in range(S) if i != j]
        P = len(pairs)
        out = {k: np.zeros(shape, np.float32) for k, shape in (
            ("src_coords", (P, N, 2)), ("dst_coords", (P, N, 2)), ("src_depth", (P, N)),
            ("dst_depth", (P, N)))}
        for p, (i, j) in enumerate(pairs):
            uv = rng.uniform((0, 0), (self.W0, self.H0), size=(3 * N, 2))
            pts, z_src = self._hit(poses[i], plane, uv)
            dst, z_dst = self._project(poses[j], pts)
            ok = np.flatnonzero((dst[:, 0] >= 0) & (dst[:, 0] < self.W0) & (dst[:, 1] >= 0)
                                & (dst[:, 1] < self.H0) & (z_dst > 0))
            take = ok[:N] if len(ok) >= N else rng.choice(ok, N, replace=True)
            out["src_coords"][p], out["dst_coords"][p] = uv[take], dst[take]
            out["src_depth"][p], out["dst_depth"][p] = z_src[take], z_dst[take]
        return {
            "scene_name": f"synthetic_{idx:03d}",
            "image_names": [f"{i:06d}.jpg" for i in range(S)],
            "images": images, "depth_processed": depths,
            "K_to_K_prime": np.broadcast_to(k2kp, (S, 3, 3)).copy(),
            "K_prime_to_K": np.broadcast_to(kp2k, (S, 3, 3)).copy(),
            "K_gt": np.broadcast_to(Kgt, (S, 3, 3)).copy(),
            "poses_w2c_gt": np.concatenate(
                [poses, np.broadcast_to([0.0, 0, 0, 1], (S, 1, 4))], 1).astype(np.float32),
            "src_idx": np.array([i for i, _ in pairs], np.int32),
            "dst_idx": np.array([j for _, j in pairs], np.int32),
            **out, "pair_valid": np.ones(P, np.float32), "shared_focal": False,
        }


def _read_model_equal(model_txt: str, model_bin: str) -> list:
    """The COLMAP model read back from its text and binary files, compared:
    the differences found (text rounds xyz / poses to 10 digits and the
    observations to 1e-4 px)."""
    import numpy as np

    from self_supervise_sfm_tpu_torch.utils.colmap_io import Reconstruction

    a, b = Reconstruction.read_text(model_txt), Reconstruction.read_binary(model_bin)
    bad = []
    if set(a.cameras) != set(b.cameras) or set(a.images) != set(b.images) or (
            set(a.points3d) != set(b.points3d)):
        return ["ids differ"]
    for i in a.images:
        ia, ib = a.images[i], b.images[i]
        if not (np.allclose(ia.qvec_wxyz, ib.qvec_wxyz, atol=1e-9)
                and np.allclose(ia.tvec, ib.tvec, rtol=1e-9, atol=1e-9)
                and np.allclose(ia.xys, ib.xys, atol=1e-4)
                and np.array_equal(ia.point3d_ids, ib.point3d_ids)):
            bad.append(f"image {i}")
    for i in a.points3d:
        pa, pb = a.points3d[i], b.points3d[i]
        if not (np.allclose(pa.xyz, pb.xyz, rtol=1e-9, atol=1e-9) and pa.track == pb.track):
            bad.append(f"point {i}")
    for i in a.cameras:
        if not np.allclose(a.cameras[i].params, b.cameras[i].params, rtol=1e-9):
            bad.append(f"camera {i}")
    return bad


def _rec_residuals(rec):
    """Reprojection residual norms (O,) of every observation of a
    Reconstruction, float64 on the host."""
    import numpy as np

    from self_supervise_sfm_tpu_torch.utils import colmap_io as CIO

    pts, exts, Ks = CIO.reconstruction_to_batch_matrix(rec)
    _, _, ci, pi, uv = CIO.observations(rec)
    cam = np.einsum("oij,oj->oi", exts[ci, :, :3], pts[pi]) + exts[ci, :, 3]
    pix = np.einsum("oij,oj->oi", Ks[ci], cam)
    return np.linalg.norm(pix[:, :2] / pix[:, 2:] - uv, axis=-1)


def _huber_cost(r, delta: float = 4.0) -> float:
    import numpy as np

    return float(np.where(r <= delta, 0.5 * r * r, delta * (r - 0.5 * delta)).sum())


def run_known_geometry_ba(num_frames: int, num_tracks: int):
    """Phase 7, bundle adjustment on known geometry: tracks of the synthetic
    plane projected with the true poses and K plus 0.5 px noise, the poses
    perturbed (camera 0 kept: the gauge), then ``tracks_to_reconstruction``
    with the torch engine on the card (twice: its spread) and the native
    engine. Each must bring the reprojection RMSE down to the noise and the
    ATE against the true poses down; the engines' final Huber costs (one
    formula over each output, float64) must agree within 1e-3 relative."""
    import numpy as np
    import torch

    from self_supervise_sfm_tpu_torch.ops import geometry as G
    from self_supervise_sfm_tpu_torch.pipeline import tracking as T
    from self_supervise_sfm_tpu_torch.utils.colmap_io import reconstruction_to_batch_matrix
    from self_supervise_sfm_tpu_torch.utils.evaluation import absolute_trajectory_error

    rng = np.random.default_rng((SEED, num_frames, num_tracks))
    scenes = SyntheticScenes(1, num_frames, 16, IMG, SEED + 21)
    tracks, vis, true_w2c, K = scenes.known_tracks(0, num_tracks, 0.5, rng)
    init = true_w2c.copy()
    daa = rng.normal(scale=0.004, size=(num_frames, 3)).astype(np.float32)
    dR = G.axis_angle_to_mat(torch.from_numpy(daa)).numpy()
    init[1:, :, :3] = dR[1:] @ init[1:, :, :3]
    init[1:, :, 3] += rng.normal(scale=0.015, size=(num_frames - 1, 3)).astype(np.float32)
    Ks = np.broadcast_to(K, (num_frames, 3, 3)).astype(np.float32)
    noise_rmse = 0.5 * math.sqrt(2.0)
    failures, res = [], {"frames": num_frames, "tracks": num_tracks,
                         "observations": int(vis.sum())}
    ate0 = absolute_trajectory_error(init, true_w2c)["ate_rmse"]
    outs = {}
    for name, engine in (("torch", "torch"), ("torch_repeat", "torch"), ("native", "native")):
        timings = {}
        t0 = time.perf_counter()
        rec = T.tracks_to_reconstruction(tracks, vis, init, Ks, image_size=(IMG, IMG),
                                         ba_engine=engine, device="cuda", timings=timings)
        wall = time.perf_counter() - t0
        if rec is None:
            raise AssertionError(f"known geometry {num_frames} x {num_tracks}: no point "
                                 "survived the gating")
        r = _rec_residuals(rec)
        _, ext, _ = reconstruction_to_batch_matrix(rec)
        outs[name] = rec
        row = dict(points=len(rec.points3d), observations=len(r),
                   rmse_px=float(np.sqrt((r * r).mean())), huber_cost=_huber_cost(r),
                   ate_rmse=absolute_trajectory_error(ext, true_w2c)["ate_rmse"],
                   seconds=wall, stage_seconds=timings)
        res[name] = row
    # the same reconstruction before the solve: triangulated with the
    # perturbed poses, gated, no bundle adjustment
    rec0 = T.tracks_to_reconstruction(tracks, vis, init, Ks, image_size=(IMG, IMG),
                                      run_ba=False)
    r0 = _rec_residuals(rec0)
    res["initial"] = dict(points=len(rec0.points3d), rmse_px=float(np.sqrt((r0 * r0).mean())),
                          huber_cost=_huber_cost(r0), ate_rmse=ate0)
    print(f"  known geometry, {num_frames} frames x {num_tracks} tracks "
          f"({res['observations']} observations, noise 0.5 px, RMSE of the noise "
          f"{noise_rmse:.4f} px): before BA RMSE {res['initial']['rmse_px']:.4f} px, "
          f"ATE {ate0:.6f}, {res['initial']['points']} points")
    for name in ("torch", "torch_repeat", "native"):
        row = res[name]
        print(f"    {name}: RMSE {row['rmse_px']:.4f} px, Huber cost {row['huber_cost']:.6f}, "
              f"ATE {row['ate_rmse']:.6f}, {row['points']} points, {row['seconds']:.3f} s "
              f"({', '.join(f'{k} {v:.3f} s' for k, v in row['stage_seconds'].items())})")
        if not (row["rmse_px"] <= 1.5 * noise_rmse and row["rmse_px"] < res["initial"]["rmse_px"]):
            failures.append(f"{name}: RMSE {row['rmse_px']} not down to the noise")
        if not row["ate_rmse"] < ate0:
            failures.append(f"{name}: ATE {row['ate_rmse']} not below {ate0}")
    rel = abs(res["torch"]["huber_cost"] - res["native"]["huber_cost"]) / res["native"]["huber_cost"]
    a, b = outs["torch"], outs["torch_repeat"]
    spread_pts = max(float(np.abs(a.points3d[k].xyz - b.points3d[k].xyz).max())
                     for k in a.points3d)
    spread_t = max(float(np.abs(a.images[k].tvec - b.images[k].tvec).max()) for k in a.images)
    spread_cost = abs(res["torch"]["huber_cost"] - res["torch_repeat"]["huber_cost"])
    res.update(engines_cost_rel_diff=rel, torch_spread_points=spread_pts,
               torch_spread_translation=spread_t, torch_spread_cost=spread_cost)
    print(f"    engines' final Huber costs: relative difference {rel:.3e} (tolerance 1e-3); "
          f"torch engine spread over two runs: points {spread_pts:.3e}, translations "
          f"{spread_t:.3e}, cost {spread_cost:.3e}")
    if rel > 1e-3:
        failures.append(f"engines' costs differ by {rel} relative")
    return res, failures


def _to_device(tree, device):
    """A copy of a params tree with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device) if hasattr(tree, "to") else tree


def run_demo(host_params=None):
    """Phase 7: the reconstruction demo (``demos/reconstruct.py:run``) at full
    width in both modes with ``--tracks-ba``, its launch counts, the tracker
    with K3 against the einsum path, the DINO ranking through the ViT
    kernels, and bundle adjustment on known geometry with both engines."""
    import dataclasses as dc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from self_supervise_sfm_tpu_torch.demos import reconstruct as D
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.ops import resize as RS
    from self_supervise_sfm_tpu_torch.pipeline import tracking as T
    from self_supervise_sfm_tpu_torch.pipeline import vggsfm_tracker as TV

    torch.cuda.reset_peak_memory_stats()
    wrappers = kernel_wrappers()
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    cfg = M.make_config(compute_dtype="bfloat16")
    if host_params is not None:
        params = _to_device(host_params, "cuda")
    else:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = M.cast_trunk_weights(M.init_sailrecon(cfg, gen, device="cuda"), cfg)
    tcfg = TV.VGGSfMTrackerConfig()
    tp = TV.init_vggsfm_tracker(tcfg, torch.Generator(device="cuda").manual_seed(SEED + 2))
    ds = SyntheticScenes(1, NUM_FRAMES, 16, IMG, SEED + 17, checker=True)
    work = tempfile.mkdtemp(prefix="demo_smoke_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    # every tracker call's query count, to predict K3's launches there
    calls = []
    orig_track = TV.track

    def recorded(p, images, query_points, *a, **k):
        calls.append((int(images.shape[1]), int(query_points.shape[1])))
        return orig_track(p, images, query_points, *a, **k)

    res = {"modes": {}}
    launches = dict.fromkeys(wrappers, 0)
    try:
        TV.track = recorded
        for mode in ("forward", "reloc"):
            out_dir = os.path.join(work, mode)
            args = D.parse_args(["--data-root", "-", "--out-dir", out_dir, "--mode", mode,
                                 "--num-images", str(NUM_FRAMES), "--num-scenes", "1",
                                 "--rank", str(RANK), "--tracks-ba",
                                 "--max-query-pts", "2048"])
            calls.clear()
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            results = D.run(args, ds, params=params, tracker_params=tp, tracker_cfg=tcfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = {k: w.launches for k, w in wrappers.items()}
            (name, entry), = results.items()
            k3_tracker = sum(RS.resize_kernel_applicable((s * q, 16, 16, 32), (31, 31))
                             for s, q in calls)
            base = (FORWARD_LAUNCHES if mode == "forward" else
                    {k: BUILD_LAUNCHES[k] + RELOC_LAUNCHES[k] for k in BUILD_LAUNCHES})
            want = {**base, "resize_bilinear": base["resize_bilinear"] + k3_tracker}
            print(f"  demo --mode {mode} --tracks-ba: {wall:.2f} s; tracker calls (frames, "
                  f"queries) {calls}; launches {n}")
            expect(n == want, f"demo {mode}: launch counts {n}, expected {want}")
            expect(k3_tracker > 0, f"demo {mode}: K3 never took the tracker site")
            for k, v in n.items():
                launches[k] += v
            scene_dir = os.path.join(out_dir, name)
            for f in ("pred.ply", "poses_kitti.txt"):
                expect(os.path.getsize(os.path.join(scene_dir, f)) > 0, f"demo {mode}: {f}")
            with open(os.path.join(out_dir, "results.json")) as f:
                written = json.load(f)[name]
            expect(math.isfinite(written["ate_rmse"]), f"demo {mode}: ATE {written}")
            if "ba_points" in entry:
                bad = _read_model_equal(os.path.join(scene_dir, "sparse_txt"),
                                        os.path.join(scene_dir, "sparse"))
                expect(not bad, f"demo {mode}: COLMAP models read back differ: {bad[:5]}")
                outcome = (f"{entry['ba_points']} points, {entry['ba_tracks']} observations "
                           f"exported; text and binary models read back equal: {not bad}")
            else:
                outcome = ("no reconstruction: no track survived the gating "
                           "(max_reproj_error 8 px, min track length 2)")
            print(f"    {name}: ATE {entry['ate_rmse']:.6f}, {outcome}")
            print(f"    stage seconds: " + ", ".join(
                f"{k} {v:.3f}" for k, v in entry["stage_seconds"].items()))
            res["modes"][mode] = dict(wall_s=wall, launches=n, tracker_calls=list(calls),
                                      k3_tracker_launches=k3_tracker, **entry)
    finally:
        TV.track = orig_track
        shutil.rmtree(work, ignore_errors=True)

    # the tracker with K3 against the einsum path, on the demo's frames
    scene = ds.load_scene(0, np.random.default_rng(0))
    imgs = torch.from_numpy(scene["images"]).cuda()[None]
    xy = T.extract_keypoints(scene["images"][0], max_pts=1024)
    q = torch.from_numpy(xy).cuda()[None]
    plain_cfg = dc.replace(tcfg, resize_impl="einsum")
    fk, ck, vk = TV.track(tp, imgs, q, tcfg)
    fe, ce, ve = TV.track(tp, imgs, q, plain_cfg)
    pr = tcfg.pradius
    topleft = torch.clamp(torch.floor(ck[0]).long() - pr, 0, IMG - (2 * pr + 1))
    patches = TV.extract_patches(imgs[0], topleft, 2 * pr + 1).reshape(-1, 2 * pr + 1,
                                                                      2 * pr + 1, 3)
    before = resize_launches = RS.resize_bilinear_fwd.launches
    feat_k = TV.shallow_encoder(tp["fine_fnet"], patches)
    resize_launches = RS.resize_bilinear_fwd.launches - before
    feat_e = TV.shallow_encoder(tp["fine_fnet"], patches, resize_impl="einsum")
    feat_rel = float((feat_k - feat_e).norm() / feat_e.norm())
    one_k = TV.track(tp, imgs, q, dc.replace(tcfg, fine_iters=1))[0]
    one_e = TV.track(tp, imgs, q, dc.replace(plain_cfg, fine_iters=1))[0]
    torch.cuda.synchronize()
    coarse_diff = float((ck - ce).abs().max())
    one_diff = float((one_k - one_e).abs().max())
    full_diff = float((fk - fe).abs().max())
    print(f"  tracker, {q.shape[1]} queries x {NUM_FRAMES} frames: patch features K3 vs einsum "
          f"rel-RMS {feat_rel:.3e} (tolerance 1e-5, phase 3's fp32 envelope; K3 launches "
          f"{resize_launches}); coarse tracks max diff {coarse_diff:.3e} px (no K3 site); "
          f"fine tracks after one fine iteration {one_diff:.3e} px (tolerance 1e-3); after "
          f"the default {tcfg.fine_iters} iterations {full_diff:.3e} px (for the record: the "
          f"iterated predictor amplifies rounding)")
    expect(feat_rel <= 1e-5, f"tracker patch features: {feat_rel} over 1e-5")
    expect(resize_launches == 1, "tracker patch features: K3 not launched")
    expect(coarse_diff <= 1e-3 and one_diff <= 1e-3, "tracker: K3 and einsum tracks differ")
    expect(bool(torch.isfinite(fk).all() and torch.isfinite(vk).all()), "tracker: non-finite")

    # the DINO ranking on the port's ViT: K1 and LN+QKV, against the plain path
    vit_cfg = cfg.aggregator.vit
    vit_plain = dc.replace(vit_cfg, attn_impl="dense", fused_qkv="off", fused_mlp="off")
    for w in wrappers.values():
        w.launches = 0
    rank_k = T.rank_frames_by_dino(params["aggregator"]["vit"], vit_cfg, imgs[0], 3,
                                   torch.bfloat16)
    n_rank = {k: w.launches for k, w in wrappers.items() if w.launches}
    rank_p = T.rank_frames_by_dino(params["aggregator"]["vit"], vit_plain, imgs[0], 3,
                                   torch.bfloat16)
    print(f"  rank_frames_by_dino: kernels {rank_k}, plain path {rank_p}; launches {n_rank}")
    expect(rank_k == rank_p, f"DINO ranking {rank_k} differs from the plain path's {rank_p}")
    expect(n_rank.get("flash_fwd", 0) > 0 and n_rank.get("fused_ln_qkv", 0) > 0,
           f"DINO ranking launched {n_rank}")

    # where the tracker's time goes: one profiled call
    prof = profile_forward(lambda: TV.track(tp, imgs, q, tcfg), "tracking call")
    res.update(tracker_features_rel=feat_rel, tracker_coarse_diff=coarse_diff,
               tracker_one_iter_diff=one_diff, tracker_full_diff=full_diff,
               rank_kernels=rank_k, rank_plain=rank_p, rank_launches=n_rank,
               tracker_profile=prof)
    del fk, ck, vk, fe, ce, ve, patches, feat_k, feat_e, one_k, one_e

    # bundle adjustment on known geometry: the demo's size and a larger scene
    for frames, tracks in ((NUM_FRAMES, 6144), (20, 10240)):
        r, f = run_known_geometry_ba(frames, tracks)
        res[f"ba_{frames}x{tracks}"] = r
        failures += f
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  phase 7 peak memory {res['peak_gb']:.2f} GB")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, res


def _trace_summary(path: str) -> dict:
    """Device busy, wall span, idle share and device launches (kernels,
    copies, memsets: what ``profile_forward`` counts) of a
    ``torch.profiler`` chrome trace (the trainer's profile window)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy = sum(e["dur"] for e in device) / 1e3
    wall = (t1 - t0) / 1e3
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "launches": len(device),
            "kernels": sum(e.get("cat") == "kernel" for e in device)}


def run_trainer(bare_step_ms: float):
    """Phase 6: the trainer (``train/trainer.py:run``) at phase 5's full
    width on numpy-made synthetic scenes at 518 px (2 frames, 10 000
    correspondences a pair; validation on one 8-frame scene, 2048 a pair).
    Run A takes 6 steps: checkpoints at steps 3 and 6, a profile window
    over step 2, one sanity check and one validation at step 6. The spread
    of one step from one state: the step-3 checkpoint restored twice, each
    time stepped on step 3's batch and subsample. Run B resumes from the
    step-3 checkpoint and takes steps 4-6; its metrics are held against run
    A's within that spread (bit-equal when the spread is 0), its final
    state likewise. The step-6 checkpoint restored is bit-equal to run A's
    final state. Launch counts of run A against the prediction."""
    import os
    import shutil
    import tempfile

    import torch

    from self_supervise_sfm_tpu_torch.train import checkpoint as CK
    from self_supervise_sfm_tpu_torch.train import loop as L
    from self_supervise_sfm_tpu_torch.train import trainer as T
    from self_supervise_sfm_tpu_torch.train.loss import LossConfig

    wrappers = kernel_wrappers()
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    times = {"save_s": [], "write_s": [], "restore_s": [], "val_ms": []}

    class TimedCheckpoints(CK.CheckpointManager):
        def save(self, step, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            saved = super().save(step, state)
            if saved:
                times["save_s"].append(time.perf_counter() - t0)
            return saved

        def _write(self, step, host):
            t0 = time.perf_counter()
            super()._write(step, host)
            times["write_s"].append(time.perf_counter() - t0)

        def restore(self, step=None, template=None):
            t0 = time.perf_counter()
            out = super().restore(step, template)
            torch.cuda.synchronize()
            times["restore_s"].append(time.perf_counter() - t0)
            return out

    def timed_validator(*a, **k):
        validate = make_validator(*a, **k)

        def run(params):
            t0 = time.perf_counter()
            out = validate(params)  # two floats on the host: synchronised
            times["val_ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    make_validator = T.make_validator
    T.CheckpointManager, T.make_validator = TimedCheckpoints, timed_validator
    work = tempfile.mkdtemp(prefix="trainer_smoke_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    steps, middle = 6, 3
    train = SyntheticScenes(2, TRAIN_FRAMES, 10_000, IMG, SEED + 11)
    heldout = SyntheticScenes(1, 8, 2048, IMG, SEED + 12)
    tcfg = L.TrainConfig(warmup_steps=1, adam_mu_dtype="bfloat16",
                         loss=LossConfig(max_val=30.0))
    cfg = T.TrainerConfig(
        data_root=train, results_dir=os.path.join(work, "a"), total_steps=steps,
        num_images=TRAIN_FRAMES, sample_num=10_000, rank=RANK, seed=SEED,
        checkpoint_every=middle, sanity_check_every=steps, eval_every=steps,
        eval_data_root=heldout, eval_num_images=8, eval_sample_num=2048,
        artifact_every=0, profile_start=2, profile_steps=1, log_every=1, train=tcfg)
    print("  artifact dumps off (artifact_every=0): this script runs without matplotlib; "
          "the CPU tests write the plots")
    try:
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state_a = T.run(cfg)
        torch.cuda.synchronize()
        run_a_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = {k: w.launches for k, w in wrappers.items()}
        print(f"  run A: {steps} steps in {run_a_s:.2f} s, peak memory {peak_gb:.2f} GB; "
              f"launches {launches}")
        d, v = 24, 24
        step_n = {"flash_fwd": v + 6 * d, "frame_ctx_fwd": 2 * d, "fused_ln_qkv": v,
                  "fused_ln_qkv_rope": 6 * d, "fused_proj_residual": v + 6 * d,
                  "fused_mlp_up": v + 6 * d, "fused_mlp_down": v + 6 * d,
                  "flash_bwd_dq": v + 4 * d, "flash_bwd_dkv": v + 4 * d}
        fwd_n = {"flash_fwd": v + 2 * d, "frame_ctx_fwd": d, "resize_bilinear": 2,
                 "fused_ln_qkv_rope": 3 * d, "fused_ln_qkv": v,
                 "fused_proj_residual": v + 3 * d, "fused_mlp_up": v + 3 * d,
                 "fused_mlp_down": v + 3 * d}
        # 6 train steps, one diagnostics forward (the sanity check) and one
        # validation forward, each with every head
        want = {k: steps * step_n.get(k, 0) + 2 * fwd_n.get(k, 0) for k in wrappers}
        if launches != want:
            raise AssertionError(f"trainer launch counts {launches}, expected {want}")

        def rows(results, prefix="train"):
            with open(os.path.join(results, "tensorboard", "metrics.jsonl")) as f:
                return [r for r in map(json.loads, f) if r["prefix"] == prefix]

        ra = rows(cfg.results_dir)
        for r in ra:
            print(f"  step {r['step']}: loss {r['loss']:.6g}, grad_norm {r['grad_norm']:.6g}, "
                  f"grad_norm_camera {r['grad_norm_camera']:.6g}, learning_rate "
                  f"{r['learning_rate']:.6g}, step_seconds {r['step_seconds']:.4f}")
            expect(all(math.isfinite(x) for x in r.values() if isinstance(x, float)),
                   f"step {r['step']}: non-finite metrics")
        expect([r["step"] for r in ra] == list(range(1, steps + 1)), "train rows")
        expect(any(r["loss"] < 2.0 and r["grad_norm_camera"] > 0 for r in ra),
               "every step saturated the CDF (loss 2, no camera gradient)")
        # steps/s between consecutive steps, from step 2 on (0-based step 1:
        # phase 5's median also skips the first step); the profiled step's
        # interval is left out
        rate_rows = [r for r in ra[1:] if r["step"] != cfg.profile_start + 1]
        trainer_ms = statistics.median(1e3 / r["steps_per_sec"] for r in rate_rows)
        # what else ran in each interval of run A
        during = {cfg.profile_start + 1: "profiled", middle + 1: "the step-3 save's host copy",
                  middle + 2: "the step-3 write in flight", middle + 3: "the write in flight"}
        for r in ra[1:]:
            print(f"  interval to step {r['step']}: {1e3 / r['steps_per_sec']:.2f} ms"
                  f" ({during.get(r['step'], 'the step alone')})")
        print(f"  trainer step {trainer_ms:.2f} ms median of steps "
              f"{[r['step'] for r in rate_rows]}, {1e3 / trainer_ms:.4f} steps/s; phase 5's "
              f"bare step {bare_step_ms:.2f} ms ({1e3 / bare_step_ms:.4f} steps/s): trainer / "
              f"bare {trainer_ms / bare_step_ms:.3f}")
        prof = _trace_summary(os.path.join(cfg.results_dir, "profile", "trace.json"))
        print(f"  profiled trainer step {cfg.profile_start + 1}: wall {prof['wall_ms']:.2f} ms, "
              f"device busy {prof['busy_ms']:.2f} ms (idle share {prof['idle_share']:.3f}), "
              f"{prof['launches']} device launches ({prof['kernels']} kernels)")
        (sanity,), (val,) = rows(cfg.results_dir, "sanity"), rows(cfg.results_dir, "val")
        expect(math.isfinite(sanity["mean_px_offset"]), "sanity offset not finite")
        expect(math.isfinite(val["px_residual"]) and math.isfinite(val["log_residual"]),
               "validation not finite")
        ck = os.path.join(cfg.results_dir, "checkpoints")
        ckpt_bytes = os.path.getsize(os.path.join(ck, str(middle), "state.pt"))
        print(f"  sanity check (diagnostics forward + check) {sanity['step_seconds'] * 1e3:.2f} "
              f"ms, mean offset {sanity['mean_px_offset']:.6g} px; validation "
              f"{times['val_ms'][0]:.2f} ms, px_residual {val['px_residual']:.6g}, "
              f"log_residual {val['log_residual']:.6g}")
        print(f"  checkpoint {ckpt_bytes / 1e9:.3f} GB; save (host copy) "
              f"{[round(s, 3) for s in times['save_s']]} s, write "
              f"{[round(s, 3) for s in times['write_s']]} s")

        # the step-6 checkpoint is run A's final state
        def leaves(state):
            return L._flatten([state["params"], state["opt"]["mu"], state["opt"]["nu"]])

        mgr = TimedCheckpoints(ck)
        back = mgr.restore(steps, template=state_a)
        same = [torch.equal(a, b) for a, b in zip(leaves(back), leaves(state_a))]
        expect(all(same) and back["step"] == back["opt"]["count"] == steps,
               "the step-6 checkpoint differs from run A's final state")
        del back

        # the spread of one step from one state: restore, step, twice
        model_cfg = T._model_config(cfg)
        tcfg_run = dataclasses.replace(cfg.train, total_steps=steps, rank=RANK,
                                       num_images=TRAIN_FRAMES)
        stream = T.scene_stream(train, range(1), SEED, 1, start=middle)
        batch = T.batch_to_device(next(stream), torch.device("cuda"))
        stream.close()
        step_fn = L.make_train_step(model_cfg, tcfg_run)
        repeats = []
        for _ in range(2):
            s = mgr.restore(middle, template=state_a)
            _, m = step_fn(s, batch, **T.step_subsample(SEED, middle, "cuda"))
            repeats.append(T._host_scalars(m))
            del s, m
        keys = [k for k in repeats[0] if k not in ("learning_rate",)]
        spread = max(abs(repeats[0][k] - repeats[1][k]) for k in keys)
        a4 = ra[middle]  # run A's row for step middle + 1
        spread_a = max(abs(repeats[0][k] - a4[k]) for k in keys)
        print(f"  same-state spread of step {middle + 1}: max |diff| over its metrics "
              f"{spread:.3e} between two restored runs, {spread_a:.3e} against run A; "
              f"restore {[round(s, 3) for s in times['restore_s']]} s")

        # run B: resume from the middle checkpoint
        cfg_b = dataclasses.replace(cfg, results_dir=os.path.join(work, "b"),
                                    checkpoint_every=0, profile_steps=0)
        os.makedirs(os.path.join(cfg_b.results_dir, "checkpoints"))
        os.rename(os.path.join(ck, str(middle)),
                  os.path.join(cfg_b.results_dir, "checkpoints", str(middle)))
        state_b = T.run(cfg_b)
        rb = rows(cfg_b.results_dir)
        expect([r["step"] for r in rb] == list(range(middle + 1, steps + 1)), "resumed rows")
        # run B saves nothing: its intervals are the trainer with no checkpoint
        quiet_ms = [1e3 / r["steps_per_sec"] for r in rb[1:]]
        print(f"  run B, no checkpoint in flight: intervals {[round(x, 2) for x in quiet_ms]} "
              f"ms, median / bare {statistics.median(quiet_ms) / bare_step_ms:.3f}")
        diffs = [max(abs(x[k] - y[k]) for k in keys) for x, y in zip(ra[middle:], rb)]
        leaves_b, leaves_a = leaves(state_b), leaves(state_a)
        equal_share = sum(bool(torch.equal(a, b)) for a, b in zip(leaves_a, leaves_b)) / len(leaves_a)
        tol = max(spread, spread_a)
        print(f"  resumed run B (steps {middle + 1}-{steps}) against run A: max |diff| by step "
              f"{[f'{x:.3e}' for x in diffs]}; final leaves bit-equal {equal_share:.4f}; "
              f"tolerance: the same-state spread {tol:.3e}")
        if tol == 0.0:
            expect(max(diffs) == 0.0 and equal_share == 1.0,
                   "the resumed run is not bit-equal to the uninterrupted one")
        else:
            expect(diffs[0] <= tol, f"resumed step {middle + 1} off by {diffs[0]} > {tol}")
        (val_b,) = rows(cfg_b.results_dir, "val")
        expect(tol > 0 or val_b["px_residual"] == val["px_residual"], "resumed validation")
        del state_a, state_b
    finally:
        T.CheckpointManager, T.make_validator = CK.CheckpointManager, make_validator
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, dict(
        steps=steps, run_a_s=run_a_s, trainer_step_ms=trainer_ms,
        trainer_steps_per_s=1e3 / trainer_ms, bare_step_ms=bare_step_ms,
        trainer_over_bare=trainer_ms / bare_step_ms, profile=prof, peak_gb=peak_gb,
        sanity_ms=sanity["step_seconds"] * 1e3, validation_ms=times["val_ms"],
        checkpoint_gb=ckpt_bytes / 1e9, save_s=times["save_s"], write_s=times["write_s"],
        restore_s=times["restore_s"], quiet_step_ms=quiet_ms, spread=spread, spread_vs_a=spread_a,
        resume_diffs=diffs, resume_equal_share=equal_share,
        losses=[r["loss"] for r in ra])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from self_supervise_sfm_tpu_torch import _kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _kernels.library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s")
    print_build_log(_kernels.build_log)
    print_sm90_build()

    if "--train-only" in sys.argv[1:]:
        print("phase 5 alone: full-width train step")
        _, train = run_train()
        print(json.dumps({"train": train}))
        return 0
    if "--demo-only" in sys.argv[1:]:
        print("phase 7 alone: the reconstruction demo (forward and reloc with --tracks-ba), "
              "the tracker, the DINO ranking, bundle adjustment on known geometry")
        _, demo = run_demo()
        print(json.dumps({"demo": demo}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--trainer-only" in sys.argv[1:]:
        print("phases 5 and 6 alone: the bare train step, then the trainer around it")
        _, train = run_train()
        torch.cuda.empty_cache()
        _, trainer = run_trainer(train["step_ms"])
        print(f"{card}: trainer {trainer['trainer_steps_per_s']:.4f} steps/s against the bare "
              f"step's {train['steps_per_s']:.4f}, peak memory {trainer['peak_gb']:.2f} GB")
        print(json.dumps({"trainer": trainer}))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print("phase 2: kernels against their plain versions at main-path shapes")
    kernels = check_kernels(gen)
    torch.cuda.empty_cache()
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernels": kernels}))
        return 0
    print("phase 3: full-width forward (bf16 trunk, 5 anchors + 5 queries, rank 300)")
    launches, state, fwd = run_forward(gen)
    print(f"{card}: forward {fwd['frames_per_s']:.3f} frames/s, "
          f"peak memory {fwd['peak_gb']:.3f} GB")
    print("phase 4: two-phase serving (scene-cache build, reloc; 5 and 20 anchors)")
    serving_launches, serving = run_serving(state)
    by_path = {"forward": launches, **serving_launches}
    for k in kernels:
        k["launches_by_path"] = {path: n[k["name"]] for path, n in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    print(f"{card}: build {serving['build_ms']:.2f} ms, reloc "
          f"{serving['reloc_frames_per_s']:.3f} frames/s (full heads), "
          f"{serving['fast_reloc_frames_per_s']:.3f} frames/s (fast_reloc)")
    # phase 3's weights wait on the host for phase 7 (the card's memory goes
    # to phases 5 and 6)
    demo_params = _to_device(state["params"], "cpu")
    del state
    torch.cuda.empty_cache()
    print("phase 5: full-width train step (2 frames, depth 24, rank 300, bf16 trunk, "
          "fp32 masters, remat)")
    train_launches, train = run_train()
    for k in kernels:
        k["launches_by_path"]["train"] = train_launches[k["name"]]
        k["launches"] += train_launches[k["name"]]
    print(f"{card}: train step {train['step_ms']:.2f} ms, {train['steps_per_s']:.4f} "
          f"steps/s, peak memory {train['peak_gb']:.2f} GB")
    torch.cuda.empty_cache()
    print("phase 6: the trainer (scene stream, checkpoints and resume, validation, "
          "sanity check) around the full-width step")
    trainer_launches, trainer = run_trainer(train["step_ms"])
    for k in kernels:
        k["launches_by_path"]["trainer"] = trainer_launches[k["name"]]
        k["launches"] += trainer_launches[k["name"]]
    print(f"{card}: trainer {trainer['trainer_steps_per_s']:.4f} steps/s against the bare "
          f"step's {train['steps_per_s']:.4f}, idle share {trainer['profile']['idle_share']:.3f}, "
          f"checkpoint {trainer['checkpoint_gb']:.2f} GB, peak memory {trainer['peak_gb']:.2f} GB")
    torch.cuda.empty_cache()
    print("phase 7: the reconstruction demo (forward and reloc with --tracks-ba), the "
          "tracker, the DINO ranking, bundle adjustment on known geometry")
    demo_launches, demo = run_demo(demo_params)
    for k in kernels:
        k["launches_by_path"]["demo"] = demo_launches[k["name"]]
        k["launches"] += demo_launches[k["name"]]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was launched on no path")
    print(json.dumps({"demo": demo}))
    print(json.dumps({"forward": fwd}))
    print(json.dumps({"train": train}))
    print(json.dumps({"trainer": trainer}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
