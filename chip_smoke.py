#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``self_supervise_sfm_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each of which must pass (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   kernel in ``self_supervise_sfm_tpu_torch/csrc`` with ``nvcc`` for sm_90a;
2. each of the eight kernels at the shapes of the main path, held against
   its plain PyTorch version with the tolerance stated, and timed (CUDA
   events, median) beside its plain version, the PyTorch library call (for
   the fused block kernels: the chain of library calls) computing the same
   function (a yardstick the fused path never calls) and its bound: the
   larger of its operations at the bf16 tensor-core peak and its bytes at
   the memory peak of an H100 SXM (989 TFLOP/s, 3.35 TB/s);
3. the full-width forward of the main path: ViT-L/14 + 24 aggregator layers
   at 518 px, bf16 trunk and fp32 heads, 5 anchors + the same 5 images as
   queries, rank 300, random weights from a seeded generator, every trunk
   block on the fused LN+QKV / out-proj / MLP kernels. Launch counts are
   read around one forward; the same forward with every kernel site on its
   plain PyTorch path must agree with it (within the bf16 envelope that an
   fp32 forward measures) and give finite poses and point maps. The path
   with only the attention and resize kernels on (the fused block kernels
   off) is timed in the same run.

``python3 chip_smoke.py --kernels-only`` stops after phase 2.

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
    # the port's own kernels first: a name holding "gemm" or "norm" further
    # down must not claim them
    ("fused_ln_qkv_rope", ("fused_ln_qkv_rope_kernel",)),
    ("fused_ln_qkv", ("fused_ln_qkv_kernel",)),
    ("fused_proj_residual", ("fused_proj_residual_kernel",)),
    ("fused_mlp_up", ("fused_mlp_up_kernel",)),
    ("fused_mlp_down", ("fused_mlp_down_kernel",)),
    ("ln_stats (pre-pass of the layer-normed kernels)", ("ln_stats_kernel",)),
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
    del x, add, out, ref
    torch.cuda.empty_cache()
    results += check_fused_kernels(randn, ulps)
    for r in results:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return results


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

    def measure(name, site, outs, refs, tol_ulps, flops, tensors_in, fns):
        """One kernel at one site: check, bound, and the three timings."""
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
                    input_mb=in_bytes / 1e6, inputs_fit_l2=in_bytes <= 50e6)

    per_kernel = {k: [] for k in ("fused_ln_qkv_rope", "fused_ln_qkv", "fused_proj_residual",
                                  "fused_mlp_up", "fused_mlp_down")}
    for site, (B, n, tabs) in sites.items():
        M = B * n
        x = randn(B, n, C)
        # -- LN + QKV (+ qk-norm + RoPE) -> q, k, v (B, H, n, 64)
        if tabs is None:
            args = (x, n1["scale"], n1["bias"], at["qkv"]["w"], at["qkv"]["b"], H, 1e-6)
            kern, plain, name = FQ.fused_ln_qkv, FQ.fused_ln_qkv_plain, "fused_ln_qkv"
            chain = lambda: tuple(t.contiguous() for t in AT.qkv_heads(  # noqa: E731
                at, P.layer_norm(n1, x, 1e-6), vit_cfg))
            ins = [x, at["qkv"]["w"], at["qkv"]["b"], n1["scale"], n1["bias"]]
            tol = {"q": 2, "k": 2, "v": 2}
        else:
            args = (x, n1["scale"], n1["bias"], at["qkv"]["w"], at["qkv"]["b"],
                    qn["scale"], qn["bias"], kn["scale"], kn["bias"], *tabs, H, 1e-5)
            kern, plain = FQ.fused_ln_qkv_rope, FQ.fused_ln_qkv_rope_plain
            name = "fused_ln_qkv_rope"
            chain = lambda: tuple(t.contiguous() for t in AT.qkv_heads(  # noqa: E731
                at, P.layer_norm(n1, x, 1e-5), attn_cfg, tabs))
            ins = [x, at["qkv"]["w"], at["qkv"]["b"], n1["scale"], n1["bias"],
                   qn["scale"], qn["bias"], kn["scale"], kn["bias"], *tabs]
            tol = {"q": 4, "k": 4, "v": 2}
        per_kernel[name].append(measure(
            name, site, kern(*args), plain(*args), tol, 2.0 * M * C * 3 * C, ins,
            (lambda: kern(*args), lambda: plain(*args), chain)))
        if site == "reloc":
            continue  # the other three kernels see the ViT site's shape again
        # -- head merge + out-proj + layer-scale + residual
        o = randn(B, H, n, d)
        pargs = (o, x, at["proj"]["w"], at["proj"]["b"], p["ls1"]["gamma"])
        per_kernel["fused_proj_residual"].append(measure(
            "fused_proj_residual", site, [FQ.fused_proj_residual(*pargs)],
            [FQ.fused_proj_residual_plain(*pargs)], {"y": 2}, 2.0 * M * C * C, list(pargs),
            (lambda: FQ.fused_proj_residual(*pargs),
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
                  f"({'fit' if s_['inputs_fit_l2'] else 'exceed'} the 50 MB L2)")
        results.append(dict(
            name=name, route="cuda",
            source="self_supervise_sfm_tpu_torch/csrc/fused_block.cu",
            replaces=f"self_supervise_sfm_tpu/ops/fused_qkv.py:{lines[name]}",
            # one call at each site measured
            max_abs_err=max(s_["max_abs_err"] for s_ in ss),
            **{k: sum(s_[k] for s_ in ss)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            bound_by=ss[-1]["bound_by"], sites=ss,
        ))
    return results


def run_forward(gen):
    """Phase 3: the full-width forward through the kernels, its launch counts,
    and its agreement with the plain-path forward."""
    import torch

    from self_supervise_sfm_tpu_torch.models import aggregator as AG
    from self_supervise_sfm_tpu_torch.models import sailrecon as M
    from self_supervise_sfm_tpu_torch.ops import flash_attention as FA
    from self_supervise_sfm_tpu_torch.ops import fused_qkv as FQ
    from self_supervise_sfm_tpu_torch.ops import resize as RS

    wrappers = {"flash_fwd": FA.flash_fwd, "frame_ctx_fwd": FA.frame_ctx_fwd,
                "resize_bilinear": RS.resize_bilinear,
                "fused_ln_qkv_rope": FQ.fused_ln_qkv_rope, "fused_ln_qkv": FQ.fused_ln_qkv,
                "fused_proj_residual": FQ.fused_proj_residual,
                "fused_mlp_up": FQ.fused_mlp_up, "fused_mlp_down": FQ.fused_mlp_down}
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
    # per forward: 24 ViT + 24 x (frame, reloc, global) blocks
    expected = {"flash_fwd": 72, "frame_ctx_fwd": 24, "resize_bilinear": 2,
                "fused_ln_qkv_rope": 72, "fused_ln_qkv": 24, "fused_proj_residual": 96,
                "fused_mlp_up": 96, "fused_mlp_down": 96}
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
    return launches, dict(
        step_ms=step * 1e3, frames_per_s=fps, peak_gb=peak_gb,
        times_ms=[t * 1e3 for t in times],
        unfused_step_ms=unfused_step * 1e3, unfused_frames_per_s=NUM_FRAMES / unfused_step,
        unfused_peak_gb=unfused_peak_gb, unfused_times_ms=[t * 1e3 for t in unfused_times],
        plain_step_ms=plain_step * 1e3, plain_frames_per_s=NUM_FRAMES / plain_step,
        plain_peak_gb=plain_peak_gb,
        trunk_ms=trunk_ms, heads_ms=heads_ms, profile=breakdown,
        unfused_profile=unfused_breakdown)


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
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernels": kernels}))
        return 0
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
