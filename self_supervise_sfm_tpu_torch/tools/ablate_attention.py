"""What each choice of the Hopper attention bodies (K1, K2; B9) is worth: ablations.

    python3 -m self_supervise_sfm_tpu_torch.tools.ablate_attention [forward] [backward]

(one CUDA card; both parts when neither is named).

Builds copies of ``csrc/flash_fwd_sm90.cu`` under ``build/ablation_attention/``
(``sm90_common.cuh`` included from ``csrc/`` through ``-I``) with one
choice of the design undone by a textual patch (each patch must find its
text, or the script fails), all builds in parallel, and times the K1
entry at the ViT, frame and global sites of the main path and the K2 entry
at the reloc site, 20 launches back to back between CUDA events
(``tools/timing.py``), each beside SDPA on the same inputs. Every variant
but "no out stores" computes the same function and is held against the
plain version with phase 2's tolerance.

Then a sweep of the shipped build at a constant 924 work tiles (seven rounds
of 132 blocks) with 1 to 64 key tiles each: time a round = fixed cost of a
work tile + key tiles x cost of a key tile.

Reads: "exact softmax rounding" is exp2f, round(s * c) - m and O / l as the
plain versions round them; "no ping-pong" lets both consumer warpgroups issue
their products whenever they are ready; "2 stages" / "4 stages" change the
K / V ring; "no out stores" drops the epilogue's global stores.

The backward part does the same for ``csrc/flash_bwd_sm90.cu`` (builds under
``build/ablation_attention_bwd/``): the dq and dk/dv entries at the train
step's ViT, frame, global and split-context sites, and their RelocMask
entries at the train step's reloc layer 0 (16, 2748, 3358) under
RelocMask(610, 1374, 2), each beside SDPA's whole backward
(``torch.autograd.grad`` through SDPA; with the boolean mask at the masked
site), held against ``flash_bwd_plain`` with phase 2's tolerance (4 ulps)
but for "products only". Variants: "products only" drops the p / ds step
(the fp32 S and dP are packed as they are: no exp2, no lse / delta); "K / V
from shared memory" reads dk/dv's A operands of S^T / dP^T through
descriptors in place of register fragments; "no ping-pong" lets the
consumer warpgroups of both kernels issue whenever ready; "row values by
plain loads" has the producer warp load lse / delta into registers and
store them, in place of the 4-byte cp.async copies; "dk/dv q tiles of 128"
streams 128-row Q / dO tiles (m64n128 products for S^T / dP^T, K / V from
shared memory; ptxas spills, printed); "dq key tiles of 64" streams 64-key
K / V tiles; "2 stages" / "4 stages" change both rings; the masked walk's
order: "round-robin walk" (no odd rounds backwards) and "frame tiles first"
(dk/dv's context tiles last). Each variant's ptxas registers and spills
are printed.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from .. import _kernels
from ..ops import flash_attention as FA
from ..ops.mask_spec import RelocMask
from .timing import back_to_back_ms

SOURCE = "flash_fwd_sm90.cu"
BWD_SOURCE = "flash_bwd_sm90.cu"
LOG2E = 1.4426950408889634

EXACT_SOFTMAX = [
    ("  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));",
     "  y = exp2f(x);"),
] + [
    (f"s[4 * j{e}] = exp2_ftz(fmaf(s[4 * j{e}], scale_log2, -n{r}));",
     f"s[4 * j{e}] = exp2_ftz(__fmul_rn(s[4 * j{e}], scale_log2) - n{r});")
    for e, r in (("", 0), (" + 1", 0), (" + 2", 1), (" + 3", 1))
] + [
    ("pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0)", "pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0)"),
    ("pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1)",
     "pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1)"),
]
NO_PINGPONG = [
    ("      asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(1 + cw) : \"memory\");",
     "      if (p.nq < 0) asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(1 + cw) : \"memory\");"),
    ("      if (!last) asm volatile(", "      if (!last && p.nq < 0) asm volatile("),
    ("    if (cw == 0 && kv_tiles > 0) asm", "    if (cw == 0 && kv_tiles > 0 && p.nq < 0) asm"),
]
NO_STORES = [
    ("        if (r0 < p.nq)\n          *reinterpret_cast",
     "        if (r0 < p.nq && p.nq < 0)\n          *reinterpret_cast"),
    ("        if (r1 < p.nq)\n          *reinterpret_cast",
     "        if (r1 < p.nq && p.nq < 0)\n          *reinterpret_cast"),
]


def _stages(n: int):
    return [("constexpr int STAGES = 3;", f"constexpr int STAGES = {n};")]


VARIANTS = {
    "as shipped": [],
    "exact softmax rounding": EXACT_SOFTMAX,
    "no ping-pong": NO_PINGPONG,
    "2 stages": _stages(2),
    "4 stages": _stages(4),
    "no out stores": NO_STORES,
}

BWD_PRODUCTS_ONLY = [
    ("            float pe = exp2_ftz(fmaf(s[4 * j + e], p.scale_log2, -((e & 1) ? l2.y : l2.x)));",
     "            float pe = s[4 * j + e];"),
    ("            dp[4 * j + e] = pe * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * p.scale;",
     "            dp[4 * j + e] = pe + dp[4 * j + e];"),
    ("            float pe = exp2_ftz(fmaf(s[4 * j + e], p.scale_log2, -((e >> 1) ? lse1 : lse0)));",
     "            float pe = s[4 * j + e];"),
    ("            dp[4 * j + e] = pe * (dp[4 * j + e] - ((e >> 1) ? dl1 : dl0)) * p.scale;",
     "            dp[4 * j + e] = pe + dp[4 * j + e];"),
]
BWD_PLAIN_LOADS = [
    ("            cp_async_4(rowv + 4 * r, lse + row, ok ? 4 : 0);\n"
     "            cp_async_4(rowv + 4 * (KV_BQ + r), delta + row, ok ? 4 : 0);",
     "            float* gv = reinterpret_cast<float*>(gbase + (rowv - base));\n"
     "            gv[r] = ok ? lse[row] : 0.f;\n"
     "            gv[KV_BQ + r] = ok ? delta[row] : 0.f;"),
    ("          cp_async_arrive(full);", "          mbar_arrive(full);"),
]


_KV_SHARED = ("constexpr bool KV_IN_REGS = true;", "constexpr bool KV_IN_REGS = false;")


def _bwd_stages(n: int):
    return [("constexpr int KV_STAGES = 3;", f"constexpr int KV_STAGES = {n};"),
            ("constexpr int DQ_STAGES = 3;", f"constexpr int DQ_STAGES = {n};")]


BWD_VARIANTS = {
    "as shipped": [],
    "products only": BWD_PRODUCTS_ONLY,
    "K / V from shared memory": [_KV_SHARED],
    "no ping-pong": [("constexpr bool PINGPONG = true;", "constexpr bool PINGPONG = false;")],
    "row values by plain loads": BWD_PLAIN_LOADS,
    "dk/dv q tiles of 128": [("constexpr int KV_BQ = 64;", "constexpr int KV_BQ = 128;"),
                             _KV_SHARED],
    "dq key tiles of 64": [("constexpr int DQ_BK = 128;", "constexpr int DQ_BK = 64;")],
    "2 stages": _bwd_stages(2),
    "4 stages": _bwd_stages(4),
    "round-robin walk": [("constexpr bool SNAKE = true;", "constexpr bool SNAKE = false;")],
    "frame tiles first": [("constexpr bool CTX_FIRST = true;", "constexpr bool CTX_FIRST = false;")],
}


def patched_sources(source: str, variants) -> dict:
    """Each variant's text of ``source``; every patch must find its text
    exactly once (checked before the first nvcc starts)."""
    text = (Path(_kernels._SRC_DIR) / source).read_text()
    sources = {}
    for name, patches in variants.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: patch does not apply: {old!r}")
            src = src.replace(old, new)
        sources[name] = src
    return sources


def build_all(variants, source: str = SOURCE, subdir: str = "ablation_attention",
              entries=("sfm_flash_fwd_bf16", "sfm_frame_ctx_fwd_bf16")):
    """One shared library a variant, every nvcc started together; the
    libraries and each variant's nvcc / ptxas log."""
    sources = patched_sources(source, variants)
    root = _kernels.BUILD_DIR.parent / subdir
    jobs = {}
    for i, (name, src) in enumerate(sources.items()):
        out = root / f"v{i}"
        out.mkdir(parents=True, exist_ok=True)
        (out / source).write_text(src)
        so = out / "lib.so"
        # the copy includes sm90_common.cuh from csrc/
        cmd = [_kernels._nvcc(), *_kernels._CFLAGS, "-I", str(_kernels._SRC_DIR), "-shared",
               str(out / source), "-o", str(so)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = _kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name], logs[name] = lib, log
    return libs, logs


def _launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("ablate_attention: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    parts = set(argv) or {"forward", "backward"}
    if "forward" in parts:
        forward()
    if "backward" in parts:
        backward()
    return 0


def forward() -> None:
    libs, _ = build_all(VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    stream = torch.cuda.current_stream().cuda_stream
    scale = 64**-0.5 * LOG2E
    tol = lambda ref: 4 * 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)  # noqa: E731
    rows = {name: [] for name in libs}
    sdpa = []
    for site, bh, n in (("vit", 80, 1374), ("frame", 160, 1374), ("global", 16, 6870)):
        q, k, v = randn(bh, n, 64), randn(bh, n, 64), randn(bh, n, 64)
        ref, _ = FA.flash_fwd_plain(q, k, v)
        for name, lib in libs.items():
            o, lse = torch.empty_like(q), torch.empty(bh, n, device="cuda")
            call = lambda: _launch(lib.sfm_flash_fwd_bf16(  # noqa: E731
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, n,
                n, scale, stream), name)
            call()
            torch.cuda.synchronize()
            if name != "no out stores" and float((o.float() - ref.float()).abs().max()) > tol(ref):
                raise AssertionError(f"{name} at {site}: out of tolerance")
            rows[name].append(back_to_back_ms(call))
        sdpa.append(back_to_back_ms(
            lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])))
    P, nc, frames = 1374, 1525, 5
    q, k, v = (randn(frames, 16, P, 64) for _ in range(3))
    ck, cv = randn(1, 16, nc, 64), randn(1, 16, nc, 64)
    ref = FA._frame_ctx_dense(q, k, v, ck, cv)
    for name, lib in libs.items():
        o = torch.empty_like(q)
        call = lambda: _launch(lib.sfm_frame_ctx_fwd_bf16(  # noqa: E731
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ck.data_ptr(), cv.data_ptr(), o.data_ptr(),
            frames, 16, frames, P, nc, scale, stream), name)
        call()
        torch.cuda.synchronize()
        if name != "no out stores" and float((o.float() - ref.float()).abs().max()) > tol(ref):
            raise AssertionError(f"{name} at K2: out of tolerance")
        rows[name].append(back_to_back_ms(call))
    kk, vv = torch.cat([ck.expand(frames, -1, -1, -1), k], 2), torch.cat(
        [cv.expand(frames, -1, -1, -1), v], 2)
    sdpa.append(back_to_back_ms(lambda: F.scaled_dot_product_attention(q, kk, vv)))
    print("ms, 20 launches back to back: K1 ViT (80, 1374) | K1 frame (160, 1374) | "
          "K1 global (16, 6870) | K2 (5, 16, 1374) ctx 1525")
    for name, ts in rows.items():
        print(f"  {name:24s} " + " | ".join(f"{t:.4f}" for t in ts))
    print(f"  {'SDPA':24s} " + " | ".join(f"{t:.4f}" for t in sdpa))

    print("sweep, 924 work tiles of 128 q rows, key tiles a work tile = k:")
    shipped = libs["as shipped"]
    for k_tiles in (1, 2, 4, 8, 16, 32, 64):
        n, bh = 128 * k_tiles, 924 // k_tiles
        q, k, v = randn(bh, n, 64), randn(bh, n, 64), randn(bh, n, 64)
        o, lse = torch.empty_like(q), torch.empty(bh, n, device="cuda")
        t = back_to_back_ms(lambda: _launch(shipped.sfm_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, n, n,
            scale, stream), "sweep"))
        rounds = bh * k_tiles / 132
        print(f"  k {k_tiles:2d}: {t:.4f} ms, {t * 1e3 / rounds:.2f} us a round, "
              f"{4.0 * bh * n * n * 64 / t / 1e9:.0f} TFLOP/s")


def backward() -> None:
    """The B9 variants at the train step's sites, unmasked and under the
    reloc layer's RelocMask, b2b, beside SDPA's backward."""
    libs, logs = build_all(BWD_VARIANTS, BWD_SOURCE, "ablation_attention_bwd",
                           ("sfm_flash_bwd_dq_sm90", "sfm_flash_bwd_dkv_sm90",
                            "sfm_flash_bwd_dq_reloc_sm90", "sfm_flash_bwd_dkv_reloc_sm90"))
    for name, log in logs.items():
        spills = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                  if "spill" in ln or "Used" in ln or "C75" in ln]
        print(f"  ptxas [{name}]: {' | '.join(spills)}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    stream = torch.cuda.current_stream().cuda_stream
    scale = 64**-0.5
    tol = lambda ref: 4 * 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)  # noqa: E731
    mask = RelocMask(610, 1374, 2)
    sites = (("vit", 32, 1374, 1374, None), ("frame", 64, 1374, 1374, None),
             ("global", 16, 2748, 2748, None), ("split context", 32, 1374, 610, None),
             ("reloc layer 0, masked", 16, mask.nq, mask.nk, mask))
    rows = {name: [] for name in libs}
    sdpa = []
    for site, bh, nq, nk, mask in sites:
        q, do, k, v = randn(bh, nq, 64), randn(bh, nq, 64), randn(bh, nk, 64), randn(bh, nk, 64)
        o, lse = FA.flash_fwd_plain(q, k, v, mask)
        delta = FA._delta(o, do).contiguous()
        ref = FA.flash_bwd_plain(q, k, v, o, lse, do, mask=mask)
        for name, lib in libs.items():
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    delta.data_ptr())
            if mask is None:
                dq_entry, dkv_entry, extra = (lib.sfm_flash_bwd_dq_sm90,
                                              lib.sfm_flash_bwd_dkv_sm90, ())
            else:
                dq_entry, dkv_entry, extra = (lib.sfm_flash_bwd_dq_reloc_sm90,
                                              lib.sfm_flash_bwd_dkv_reloc_sm90,
                                              (mask.n_ctx, mask.frame_size))
            call_dq = lambda: _launch(dq_entry(  # noqa: E731
                *args, dq.data_ptr(), bh, nq, nk, *extra, scale * LOG2E, scale, stream), name)
            call_dkv = lambda: _launch(dkv_entry(  # noqa: E731
                *args, dk.data_ptr(), dv.data_ptr(), bh, nq, nk, *extra, scale * LOG2E, scale,
                stream), name)
            call_dq()
            call_dkv()
            torch.cuda.synchronize()
            if name != "products only":
                for label, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                    if float((g.float() - r.float()).abs().max()) > tol(r):
                        raise AssertionError(f"{name} at {site}: {label} out of tolerance")
            rows[name].append((back_to_back_ms(call_dq), back_to_back_ms(call_dkv)))
        qm, km, vm = (t[None].detach().requires_grad_() for t in (q, k, v))
        attn_mask = None if mask is None else mask.materialize("cuda")
        out = F.scaled_dot_product_attention(qm, km, vm, attn_mask=attn_mask)
        sdpa.append(back_to_back_ms(lambda: torch.autograd.grad(  # noqa: E731
            out, (qm, km, vm), do[None], retain_graph=True)))
        del q, do, k, v, o, lse, delta, ref, out, qm, km, vm
        torch.cuda.empty_cache()
    print("ms, 20 launches back to back, dq / dk/dv: " + " | ".join(
        f"{site} ({bh}, {nq}, {nk})" for site, bh, nq, nk, _ in sites))
    for name, ts in rows.items():
        print(f"  {name:28s} " + " | ".join(f"{a:.4f} / {b:.4f}" for a, b in ts))
    print(f"  {'SDPA backward (all three)':28s} " + " | ".join(f"{t:.4f}" for t in sdpa))
    # a product over the allowed pairs
    flops = [2.0 * bh * nq * (nk if m is None else m.n_ctx + m.frame_size) * 64
             for _, bh, nq, nk, m in sites]
    for name, ts in rows.items():
        print(f"  {name:28s} TFLOP/s dq / dk/dv: " + " | ".join(
            f"{3 * f / a / 1e9:.0f} / {4 * f / b / 1e9:.0f}" for f, (a, b) in zip(flops, ts)))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
