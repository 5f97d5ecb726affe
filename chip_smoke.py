#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``self_supervise_sfm_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each of which must pass (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   kernel in ``self_supervise_sfm_tpu_torch/csrc`` with ``nvcc`` for sm_90a;
2. each kernel at the shapes of the main path, held against its plain
   PyTorch version with the tolerance stated, and timed (CUDA events,
   median) beside its plain version, one PyTorch library call computing the
   same function (a yardstick the port never calls) and its bound: the
   larger of its operations at the bf16 tensor-core peak and its bytes at
   the memory peak of an H100 SXM (989 TFLOP/s, 3.35 TB/s);
3. the full-width forward of the main path: ViT-L/14 + 24 aggregator layers
   at 518 px, bf16 trunk and fp32 heads, 5 anchors + the same 5 images as
   queries, rank 300, random weights from a seeded generator. Launch counts
   are read around one forward; the same forward with every kernel site on
   its plain PyTorch path must agree with it (within the bf16 envelope that
   an fp32 forward measures) and give finite poses and point maps.

The line before the last is a JSON object of every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
NUM_FRAMES = 5
IMG = 518
RANK = 300
SEED = 0


def _time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    ("flash_fwd (K1)", ("flash_fwd_kernel",)),
    ("frame_ctx_fwd (K2)", ("frame_ctx_fwd_kernel",)),
    ("resize_bilinear (K3)", ("resize_bilinear_ac_kernel",)),
    ("convolution", ("conv", "fprop", "dgrad", "winograd", "implicit")),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("softmax / reduction", ("softmax", "reduce", "norm")),
    ("copy / layout", ("copy", "cat", "transpose", "memcpy", "memset", "index",
                       "gather", "scatter")),
)


def profile_forward(fn) -> dict:
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
    print(f"  profiled forward: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
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
        ))
        del q, k, v, out, lse, p_out, p_lse
    results.append(dict(
        name="flash_fwd", route="cuda",
        source="self_supervise_sfm_tpu_torch/csrc/flash_attention.cu",
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
        name="frame_ctx_fwd", route="cuda",
        source="self_supervise_sfm_tpu_torch/csrc/flash_attention.cu",
        replaces="self_supervise_sfm_tpu/ops/flash_attention.py:539",
        max_abs_err=err,
        ms=_time_ms(lambda: FA.frame_ctx_fwd(q, k, v, ck, cv)),
        plain_ms=_time_ms(lambda: FA._frame_ctx_dense(q, k, v, ck, cv), reps=5),
        # SDPA over the [ctx ‖ own] K/V concatenated beforehand
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(q, kk, vv)),
        bound_ms=bound, bound_by=by,
    ))
    del q, k, v, ck, cv, kk, vv, out, ref

    # -- K3: final DPT upsample 296 -> 518 with the fused pos-embed addend --
    H0 = 4 * (IMG // 14) * 2  # 296
    x = randn(NUM_FRAMES, H0, H0, 128, dtype=torch.float32)
    add = randn(IMG, IMG, 128, dtype=torch.float32)
    out = RS.resize_bilinear(x, (IMG, IMG), add, torch.bfloat16)
    torch.cuda.synchronize()
    ref = RS.resize_bilinear_plain(x, (IMG, IMG), add, torch.bfloat16)
    err = float((out.float() - ref.float()).abs().max())
    _check(f"resize_bilinear {tuple(x.shape)} -> {IMG} bf16", err, ulps(ref, 1))
    err32 = float((RS.resize_bilinear(x, (IMG, IMG), add)
                   - RS.resize_bilinear_plain(x, (IMG, IMG), add)).abs().max())
    _check("resize_bilinear fp32 store", err32, 1e-5 * float(ref.float().abs().max()))

    def library():
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(IMG, IMG), mode="bilinear",
                          align_corners=True)
        return (y.permute(0, 2, 3, 1) + add).to(torch.bfloat16)

    bound, by = _bound_ms(0.0, x.numel() * 4 + add.numel() * 4 + out.numel() * 2)
    results.append(dict(
        name="resize_bilinear", route="cuda",
        source="self_supervise_sfm_tpu_torch/csrc/resize.cu",
        replaces="self_supervise_sfm_tpu/ops/resize.py:51,136",
        max_abs_err=err,
        ms=_time_ms(lambda: RS.resize_bilinear(x, (IMG, IMG), add, torch.bfloat16)),
        plain_ms=_time_ms(lambda: RS.resize_bilinear_plain(x, (IMG, IMG), add,
                                                           torch.bfloat16), reps=5),
        library_ms=_time_ms(library),
        bound_ms=bound, bound_by=by,
    ))
    for r in results:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return results


def run_forward(gen):
    """Phase 3: the full-width forward through the kernels, its launch counts,
    and its agreement with the plain-path forward."""
    import torch

    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops import resize as RS

    wrappers = {"flash_fwd": FA.flash_fwd, "frame_ctx_fwd": FA.frame_ctx_fwd,
                "resize_bilinear": RS.resize_bilinear}
    cfg = M.make_config(compute_dtype="bfloat16")
    cfg_plain = M.make_config(compute_dtype="bfloat16", attn_impl="dense",
                              global_attn_impl="dense", resize_impl="einsum")
    cfg_f32 = M.make_config(attn_impl="dense", global_attn_impl="dense",
                            resize_impl="einsum")
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
    expected = {"flash_fwd": 72, "frame_ctx_fwd": 24, "resize_bilinear": 2}
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fwd(cfg, params)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    before = {k: w.launches for k, w in wrappers.items()}
    plain = fwd(cfg_plain, params)
    f32 = fwd(cfg_f32, p32)
    torch.cuda.synchronize()
    if {k: w.launches for k, w in wrappers.items()} != before:
        raise AssertionError("the plain-path forward launched a kernel")
    t0 = time.perf_counter()
    fwd(cfg_plain, params)
    torch.cuda.synchronize()
    plain_step = time.perf_counter() - t0

    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    shapes = {"extrinsic": (1, 5, 3, 4), "intrinsic": (1, 5, 3, 3),
              "point_map": (1, 5, IMG, IMG, 3), "xyz_cnf": (1, 5, IMG, IMG),
              "depth_map": (1, 5, IMG, IMG, 1), "dpt_cnf": (1, 5, IMG, IMG),
              "point_map_by_unprojection": (1, 5, IMG, IMG, 3),
              "cam_tokens": (1, 5, 2048)}
    for k, shape in shapes.items():
        expect(tuple(out[k].shape) == shape, f"{k}: shape {tuple(out[k].shape)}")
        share = float(torch.isfinite(out[k]).float().mean())
        print(f"  {k}: finite share {share:.6f} (kernel path)")

    # trunk (K1, K2): the kernel path's aggregator output against the plain
    # path's, in relative RMS; the yardstick is what bf16 itself moves the
    # plain path away from an fp32 forward
    def agg(c, p):
        return AG.aggregator_forward(p["aggregator"], c.aggregator, images, NUM_FRAMES,
                                     NUM_FRAMES, RANK, generator=draw(),
                                     images_duplicated=True)

    tk, psi, ck = agg(cfg, params)
    tp, _, cp = agg(cfg_plain, params)
    tf, _, cf = agg(cfg_f32, p32)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

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
        for a, b in ((hk32[k], hp32[k]), (hk[k], hp[k])):
            ya, yb = _logit(k, a.float()), _logit(k, b.float())
            fa, fb = torch.isfinite(ya), torch.isfinite(yb)
            both, flip = fa & fb, fa ^ fb
            expect(bool((torch.where(fa, ya, yb)[flip].abs() > edge).all()),
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
    breakdown = profile_forward(lambda: fwd(cfg, params))
    fps = NUM_FRAMES / step
    print(f"  forward: {step * 1e3:.2f} ms median of 5 ({fps:.3f} frames/s, "
          f"{NUM_FRAMES} frames of {IMG} px), peak memory {peak_gb:.2f} GB; "
          f"plain-path forward {plain_step * 1e3:.2f} ms")
    return launches, dict(step_ms=step * 1e3, frames_per_s=fps, peak_gb=peak_gb,
                          plain_step_ms=plain_step * 1e3, times_ms=[t * 1e3 for t in times],
                          trunk_ms=trunk_ms, heads_ms=heads_ms, profile=breakdown)


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
    for line in _kernels.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  " + line.strip())

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    print("phase 2: kernels against their plain versions at main-path shapes")
    kernels = check_kernels(gen)
    torch.cuda.empty_cache()
    print("phase 3: full-width forward (bf16 trunk, 5 anchors + 5 queries, rank 300)")
    launches, fwd = run_forward(gen)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"{card}: forward {fwd['frames_per_s']:.3f} frames/s, "
          f"peak memory {fwd['peak_gb']:.3f} GB")
    print(json.dumps({"forward": fwd}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
