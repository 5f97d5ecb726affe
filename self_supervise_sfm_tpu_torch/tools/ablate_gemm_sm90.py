"""What each choice of the Hopper GEMM body (LN+QKV+RoPE, LN+QKV, the
out-projection, MLP-up, MLP-down) is worth.

    python3 -m self_supervise_sfm_tpu_torch.tools.ablate_gemm_sm90   # one CUDA card
    python3 -m self_supervise_sfm_tpu_torch.tools.ablate_gemm_sm90 "as shipped" "4 stages"

Builds copies of ``csrc/gemm_sm90.cu`` under ``build/ablation_gemm_sm90/``
with one choice of the design undone by a textual patch (each patch must
find its text, or the script fails; the copies include ``sm90_common.cuh``
from ``csrc/`` through ``-I``), all builds in parallel, and times the five
kernels at the frame site (10 x 1374 rows) and the ViT site (5 x 1374 rows,
the shape of the reloc and global sites too) of the main path, 20 launches
back to back between CUDA events (``tools/timing.py``), beside the library
chains (``F.layer_norm``, cuBLAS, ``F.gelu``; cuBLAS, scale and add; for
LN+QKV(+RoPE) the plain version with cuBLAS products; for the
out-projection the head merge, cuBLAS, scale and add) and cuBLAS's bare
product on the same inputs (the out-projection's on the merged heads).
Names on the command line pick variants ("as shipped" always runs). A patch
that takes code out does so by a condition that is never true (a negative
row count), so the compiler keeps the code around it. Every variant
that still computes the function is held against the plain versions with
phase 2's tolerance (2 bf16 ulps at the largest output, 4 for q and k). One
eps (1e-5) for every layer norm, so that every kernel's pre-pass writes the
same hn.

Reads: "products only" drops the TMA copies (the producer arrives on each
stage without loading it) and the epilogue, the wgmma ceiling of this
tiling; "copies only" drops the products and the epilogue; "no epilogue"
keeps copies and products; "3 stages" / "4 stages" / "6 stages" change
the ring; "cooperative 256 x 128" puts both consumer warpgroups on one
tile of twice the rows (B read from L2 half as often, the epilogue
exposed; 4 stages of 48 KB) in place of ping-pong on alternate 128 x 128
tiles; "grouped raster" walks groups of 8 row tiles column by column in
place of row by row; "GELU without erff" (MLP-up) replaces erf(z) by z,
the cost of erff; "no pre-pass" times the layer-normed kernels on the hn an
earlier call left (the layer norm's cost is the difference), and the
pre-pass is also timed alone. The nvcc log of each variant (ptxas's
registers and spills) is left beside its library under
``build/ablation_gemm_sm90/``. The variants time the head dim 64 kernels of
the main path; the head dim 128 ones share every choice but the epilogue's
head mapping.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import torch
import torch.nn.functional as F

from .. import _kernels
from ..ops import fused_qkv as FQ
from .timing import back_to_back_ms

SOURCE = "gemm_sm90.cu"
C, CH, HEADS, NTOK, EPS = 1024, 4096, 16, 1374, 1e-5
SITES = {"frame": 10, "vit": 5}  # frames of 1374 rows
KERNELS = ("qkv_rope", "qkv", "proj", "up", "down")
ENTRIES = ("sfm_ln_qkv_rope_sm90", "sfm_ln_qkv_sm90", "sfm_proj_residual_sm90",
           "sfm_mlp_up_sm90", "sfm_mlp_down_sm90", "sfm_ln_rows_bf16")

NO_EPILOGUE = [
    ("        epilogue<EP>(p, acc, m0, m_end, n0);",
     "        if (p.M < 0) epilogue<EP>(p, acc, m0, m_end, n0);"),
    ("        epilogue_qkv<EP, HD>(p, acc, m0, n0);",
     "        if (p.M < 0) epilogue_qkv<EP, HD>(p, acc, m0, n0);"),
]
NO_COPIES = [
    ("          mbar_expect_tx(full, STAGE_BYTES);",
     "          if (p.M < 0) mbar_expect_tx(full, STAGE_BYTES); else mbar_arrive(full);"),
    ("            tma_load_3d(sa, ma, full, 0, r0, f * p.heads + kt);",
     "            if (p.M < 0) tma_load_3d(sa, ma, full, 0, r0, f * p.heads + kt);"),
    ("            tma_load_3d(sa, ma, full, BK * (kt % (HD / BK)), r0, f * p.heads + kt / (HD / BK));",
     "            if (p.M < 0)\n"
     "              tma_load_3d(sa, ma, full, BK * (kt % (HD / BK)), r0, f * p.heads + kt / (HD / BK));"),
    ("            tma_load_2d(sa, ma, full, kt * BK, f * p.frame_rows + r0);",
     "            if (p.M < 0) tma_load_2d(sa, ma, full, kt * BK, f * p.frame_rows + r0);"),
    ("          tma_load_2d(sa + A_BYTES, mb, full, n0, kt * BK);",
     "          if (p.M < 0) tma_load_2d(sa + A_BYTES, mb, full, n0, kt * BK);"),
    ("          tma_load_2d(sa + A_BYTES + B_ATOM_BYTES, mb, full, n0 + 64, kt * BK);",
     "          if (p.M < 0) tma_load_2d(sa + A_BYTES + B_ATOM_BYTES, mb, full, n0 + 64, kt * BK);"),
]
NO_PRODUCTS = [
    ("        for (int kk = 0; kk < BK / 16; ++kk) {\n          const int accumulate",
     "        for (int kk = 0; kk < (p.M < 0 ? BK / 16 : 0); ++kk) {\n          const int accumulate"),
]
NO_ERFF = [
    ("(1.0f + erff(h0 * 0.70710678118654752f))", "(1.0f + (h0 * 0.70710678118654752f))"),
    ("(1.0f + erff(h1 * 0.70710678118654752f))", "(1.0f + (h1 * 0.70710678118654752f))"),
]
NO_PREPASS = [
    ("  if (const int err = launch_ln(x, ln_w, ln_b, hn, rows, dim, eps, stream)) return err;\n"
     "  Params p = {};",
     "  if (rows < 0) launch_ln(x, ln_w, ln_b, hn, rows, dim, eps, stream);\n"
     "  Params p = {};"),
    ("  if (const int err = launch_ln(x, ln_w, ln_b, hn, rows, dim, eps, stream)) return err;\n"
     "  p.bias",
     "  if (rows < 0) launch_ln(x, ln_w, ln_b, hn, rows, dim, eps, stream);\n"
     "  p.bias"),
]


def _const(name: str, old: str, new: str):
    return [(f"constexpr {name} = {old};", f"constexpr {name} = {new};")]


VARIANTS = {
    "as shipped": [],
    "products only": NO_COPIES + NO_EPILOGUE,
    "copies only": NO_PRODUCTS + NO_EPILOGUE,
    "no epilogue": NO_EPILOGUE,
    "3 stages": _const("int STAGES", "5", "3"),
    "4 stages": _const("int STAGES", "5", "4"),
    "6 stages": _const("int STAGES", "5", "6"),
    # 4 stages: five of 48 KB do not fit
    "cooperative 256 x 128": (_const("bool PINGPONG", "true", "false")
                              + _const("int STAGES", "5", "4")),
    "grouped raster": _const("int GROUP_M", "1", "8"),
    "no pre-pass": NO_PREPASS,
    "GELU without erff": NO_ERFF,
}
# the variants that no longer compute the function
UNCHECKED = {"products only", "copies only", "no epilogue", "GELU without erff"}


def patched_sources(variants) -> dict:
    """The source of each variant; every patch must find its text once."""
    text = (_kernels._SRC_DIR / SOURCE).read_text()
    sources = {}
    for name, patches in variants.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: patch does not apply: {old!r}")
            src = src.replace(old, new)
        sources[name] = src
    return sources


def build_all(variants) -> dict:
    """One shared library a variant, every nvcc started together."""
    root = _kernels.BUILD_DIR.parent / "ablation_gemm_sm90"
    # every patch is checked before the first nvcc starts
    sources = patched_sources(variants)
    jobs = {}
    for i, (name, src) in enumerate(sources.items()):
        out = root / f"v{i}"
        out.mkdir(parents=True, exist_ok=True)
        (out / SOURCE).write_text(src)
        so = out / "lib.so"
        cmd = [_kernels._nvcc(), *_kernels._CFLAGS, "-I", str(_kernels._SRC_DIR), "-shared",
               str(out / SOURCE), "-o", str(so)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        (so.parent / "nvcc.log").write_text(log)  # ptxas's registers and spills
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = _kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_gemm_sm90: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    unknown = set(sys.argv[1:]) - set(VARIANTS)
    if unknown:
        print(f"ablate_gemm_sm90: no variant {sorted(unknown)}; variants: {list(VARIANTS)}",
              file=sys.stderr)
        return 1
    libs = build_all({name: patches for name, patches in VARIANTS.items()
                      if not sys.argv[1:] or name == "as shipped" or name in sys.argv[1:]})
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    d = C // HEADS
    wq = (randn(C, 3 * C) * C**-0.5).bfloat16()
    w1 = (randn(C, CH) * C**-0.5).bfloat16()
    w2 = (randn(CH, C) * CH**-0.5).bfloat16()
    wp, bp = (randn(C, C) * C**-0.5).bfloat16(), 0.1 * randn(C)
    bq, b1, b2, gamma = 0.1 * randn(3 * C), 0.1 * randn(CH), 0.1 * randn(C), randn(C)
    lw, lb = 1 + 0.1 * randn(C), 0.1 * randn(C)
    qw, qb, kw, kb = 1 + 0.1 * randn(d), 0.1 * randn(d), 1 + 0.1 * randn(d), 0.1 * randn(d)
    cos, sin = randn(NTOK, d).cos(), randn(NTOK, d).sin()
    stream = torch.cuda.current_stream().cuda_stream
    tol = lambda ref, n: n * 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)  # noqa: E731
    rows = {name: {} for name in libs}
    yard = {}
    for site, B in SITES.items():
        M = B * NTOK
        x = randn(B, NTOK, C, dtype=torch.bfloat16)
        hn = torch.empty((M, C), dtype=torch.bfloat16, device="cuda")
        h = FQ.fused_mlp_up_plain(x, lw, lb, w1, b1, EPS)
        o = randn(B, HEADS, NTOK, d, dtype=torch.bfloat16)
        rope_args = (x, lw, lb, wq, bq, qw, qb, kw, kb, cos, sin, HEADS, EPS)
        refs = {"qkv_rope": FQ.fused_ln_qkv_rope_plain(*rope_args),
                "qkv": FQ.fused_ln_qkv_plain(x, lw, lb, wq, bq, HEADS, EPS),
                "proj": (FQ.fused_proj_residual_plain(o, x, wp, bp, gamma),),
                "up": (h,), "down": (FQ.fused_mlp_down_plain(h, x, w2, b2, gamma),)}
        flops = {"qkv_rope": 2.0 * M * C * 3 * C, "qkv": 2.0 * M * C * 3 * C,
                 "proj": 2.0 * M * C * C, "up": 2.0 * M * C * CH, "down": 2.0 * M * C * CH}
        for name, lib in libs.items():
            q, k, v = (torch.empty((B, HEADS, NTOK, d), dtype=torch.bfloat16, device="cuda")
                       for _ in range(3))
            q2, k2, v2 = (torch.empty_like(q) for _ in range(3))
            h_out, y, yp = torch.empty_like(h), torch.empty_like(x), torch.empty_like(x)
            calls = {
                "qkv_rope": lambda: _launch(lib.sfm_ln_qkv_rope_sm90(  # noqa: E731
                    x.data_ptr(), lw.data_ptr(), lb.data_ptr(), wq.data_ptr(), bq.data_ptr(),
                    qw.data_ptr(), qb.data_ptr(), kw.data_ptr(), kb.data_ptr(), cos.data_ptr(),
                    sin.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), hn.data_ptr(), B,
                    NTOK, C, HEADS, EPS, stream), name),
                "qkv": lambda: _launch(lib.sfm_ln_qkv_sm90(  # noqa: E731
                    x.data_ptr(), lw.data_ptr(), lb.data_ptr(), wq.data_ptr(), bq.data_ptr(),
                    q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), hn.data_ptr(), B, NTOK, C,
                    HEADS, EPS, stream), name),
                "proj": lambda: _launch(lib.sfm_proj_residual_sm90(  # noqa: E731
                    o.data_ptr(), x.data_ptr(), wp.data_ptr(), bp.data_ptr(), gamma.data_ptr(),
                    yp.data_ptr(), B, NTOK, HEADS, stream), name),
                "up": lambda: _launch(lib.sfm_mlp_up_sm90(  # noqa: E731
                    x.data_ptr(), lw.data_ptr(), lb.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    h_out.data_ptr(), hn.data_ptr(), M, C, CH, EPS, stream), name),
                "down": lambda: _launch(lib.sfm_mlp_down_sm90(  # noqa: E731
                    h.data_ptr(), x.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
                    y.data_ptr(), M, CH, C, stream), name),
            }
            outs = {"qkv_rope": (q, k, v), "qkv": (q2, k2, v2), "proj": (yp,), "up": (h_out,),
                    "down": (y,)}
            for kernel in KERNELS:
                calls[kernel]()
                torch.cuda.synchronize()
            print(f"  {site}: {name} ran", flush=True)
            if name not in UNCHECKED:
                for kernel in KERNELS:
                    for i, (got, ref) in enumerate(zip(outs[kernel], refs[kernel])):
                        n = 4 if kernel == "qkv_rope" and i < 2 else 2
                        err = float((got.float() - ref.float()).abs().max())
                        if err > tol(ref, n):
                            raise AssertionError(f"{name} {kernel}[{i}] at {site}: error {err}")
            rows[name][site] = {kernel: back_to_back_ms(calls[kernel]) for kernel in KERNELS}
        pre = lambda: _launch(libs["as shipped"].sfm_ln_rows_bf16(  # noqa: E731
            x.data_ptr(), lw.data_ptr(), lb.data_ptr(), hn.data_ptr(), M, C, EPS, stream),
            "pre-pass")
        hn_ref = FQ._ln_rows(x.float(), lw, lb, EPS).bfloat16().view(M, C)
        merged = o.transpose(1, 2).reshape(M, C)
        chains = {
            "qkv_rope": lambda: FQ.fused_ln_qkv_rope_plain(*rope_args, native=True),
            "qkv": lambda: FQ.fused_ln_qkv_plain(x, lw, lb, wq, bq, HEADS, EPS, native=True),
            "proj": lambda: FQ.fused_proj_residual_plain(o, x, wp, bp, gamma, native=True),
            "up": lambda: F.gelu(F.linear(F.layer_norm(
                x.float(), (C,), lw, lb, EPS).bfloat16(), w1.t(), b1.bfloat16())),
            "down": lambda: x + F.linear(h, w2.t(), b2.bfloat16()) * gamma.bfloat16(),
        }
        products = {"qkv_rope": lambda: torch.matmul(hn_ref, wq),
                    "qkv": lambda: torch.matmul(hn_ref, wq),
                    "proj": lambda: torch.matmul(merged, wp),
                    "up": lambda: torch.matmul(hn_ref, w1),
                    "down": lambda: torch.matmul(h.view(M, CH), w2)}
        yard[site] = dict(prepass=back_to_back_ms(pre), flops=flops, M=M,
                          chain={k: back_to_back_ms(f) for k, f in chains.items()},
                          cublas={k: back_to_back_ms(f) for k, f in products.items()})
        del x, hn, h, o, merged, refs, hn_ref
        torch.cuda.empty_cache()
    for site in SITES:
        y_ = yard[site]
        print(f"{site} site, {y_['M']} rows, C {C}, 3C {3 * C}, hidden {CH}: ms and TFLOP/s, "
              f"20 launches back to back")
        print(f"  {'':24s} " + "   ".join(f"{k:>17s}" for k in KERNELS))

        def line(label, times):
            print(f"  {label:24s} " + "   ".join(
                f"{times[k]:.4f} ms {y_['flops'][k] / times[k] / 1e9:6.1f}" for k in KERNELS))

        for name, r in rows.items():
            line(name, r[site])
        line("library chain", y_["chain"])
        line("cuBLAS product alone", y_["cublas"])
        print(f"  {'pre-pass alone':24s} {y_['prepass']:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
