"""What each choice of the Hopper GEMM body (MLP-up, MLP-down) is worth.

    python3 -m self_supervise_sfm_tpu_torch.tools.ablate_gemm_sm90   # one CUDA card

Builds copies of ``csrc/gemm_sm90.cu`` under ``build/ablation_gemm_sm90/``
with one choice of the design undone by a textual patch (each patch must
find its text, or the script fails; the copies include ``sm90_common.cuh``
from ``csrc/`` through ``-I``), all builds in parallel, and times MLP-up
and MLP-down at the frame site (13740 rows) and the ViT site (6870 rows) of
the main path, 20 launches back to back between CUDA events, beside the
library chain (``F.layer_norm``, cuBLAS, ``F.gelu``; cuBLAS, scale and add)
and cuBLAS's bare product on the same inputs. A patch that takes code out
does so by a condition that is never true (a negative row count), so the
compiler keeps the code around it. Every variant that still computes the
function is held against the plain versions with phase 2's tolerance (2
bf16 ulps at the largest output).

Reads: "products only" drops the TMA copies (the producer arrives on each
stage without loading it) and the epilogue, the wgmma ceiling of this
tiling; "copies only" drops the products and the epilogue; "no epilogue"
keeps copies and products; "3 stages" / "4 stages" / "6 stages" change
the ring; "cooperative 256 x 128" puts both consumer warpgroups on one
tile of twice the rows (B read from L2 half as often, the epilogue
exposed; 4 stages of 48 KB) in place of ping-pong on alternate 128 x 128
tiles; "grouped raster" walks groups of 8 row tiles column by column in
place of row by row; "GELU without erff" (MLP-up) replaces erf(z) by z,
the cost of erff; "no pre-pass" times MLP-up on the hn an earlier call
left (the layer norm's cost is the difference), and the pre-pass is also
timed alone.
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

SOURCE = "gemm_sm90.cu"
C, CH = 1024, 4096
SITES = {"frame": 13740, "vit": 6870}

NO_EPILOGUE = [
    ("      epilogue<EP>(p, acc,", "      if (p.M < 0) epilogue<EP>(p, acc,"),
]
NO_COPIES = [
    ("          mbar_expect_tx(full, STAGE_BYTES);",
     "          if (p.M < 0) mbar_expect_tx(full, STAGE_BYTES); else mbar_arrive(full);"),
    ("          tma_load_2d(sa, ma, full, kt * BK, m0);",
     "          if (p.M < 0) tma_load_2d(sa, ma, full, kt * BK, m0);"),
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


def build_all(variants) -> dict:
    """One shared library a variant, every nvcc started together."""
    text = (_kernels._SRC_DIR / SOURCE).read_text()
    root = _kernels.BUILD_DIR.parent / "ablation_gemm_sm90"
    # every patch is checked before the first nvcc starts
    sources = {}
    for name, patches in variants.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: patch does not apply: {old!r}")
            src = src.replace(old, new)
        sources[name] = src
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
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for entry in ("sfm_mlp_up_sm90", "sfm_mlp_down_sm90", "sfm_ln_rows_bf16"):
            fn = getattr(lib, entry)
            fn.argtypes = _kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    libs = build_all(VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    w1 = (randn(C, CH) * C**-0.5).bfloat16()
    w2 = (randn(CH, C) * CH**-0.5).bfloat16()
    b1, b2, gamma = 0.1 * randn(CH), 0.1 * randn(C), randn(C)
    lw, lb = 1 + 0.1 * randn(C), 0.1 * randn(C)
    stream = torch.cuda.current_stream().cuda_stream
    tol = lambda ref: 2 * 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)  # noqa: E731
    rows = {name: {} for name in libs}
    yard = {}
    for site, M in SITES.items():
        x = randn(1, M, C, dtype=torch.bfloat16)
        hn = torch.empty((M, C), dtype=torch.bfloat16, device="cuda")
        h = FQ.fused_mlp_up_plain(x, lw, lb, w1, b1)
        ref_up, ref_down = h, FQ.fused_mlp_down_plain(h, x, w2, b2, gamma)
        flops = 2.0 * M * C * CH
        for name, lib in libs.items():
            h_out, y = torch.empty_like(h), torch.empty_like(x)
            up = lambda: _launch(lib.sfm_mlp_up_sm90(  # noqa: E731
                x.data_ptr(), lw.data_ptr(), lb.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                h_out.data_ptr(), hn.data_ptr(), M, C, CH, 1e-5, stream), name)
            down = lambda: _launch(lib.sfm_mlp_down_sm90(  # noqa: E731
                h.data_ptr(), x.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
                y.data_ptr(), M, CH, C, stream), name)
            up(), down()
            torch.cuda.synchronize()
            if name not in UNCHECKED:
                for label, got, ref in (("up", h_out, ref_up), ("down", y, ref_down)):
                    err = float((got.float() - ref.float()).abs().max())
                    if err > tol(ref):
                        raise AssertionError(f"{name} {label} at {site}: error {err}")
            t_up, t_down = time_ms(up), time_ms(down)
            rows[name][site] = (t_up, t_down, flops / t_up / 1e9, flops / t_down / 1e9)
        pre = lambda: _launch(libs["as shipped"].sfm_ln_rows_bf16(  # noqa: E731
            x.data_ptr(), lw.data_ptr(), lb.data_ptr(), hn.data_ptr(), M, C, 1e-5, stream),
            "pre-pass")
        chain_up = lambda: F.gelu(F.linear(F.layer_norm(  # noqa: E731
            x.float(), (C,), lw, lb, 1e-5).bfloat16(), w1.t(), b1.bfloat16()))
        chain_down = lambda: x + F.linear(h, w2.t(), b2.bfloat16()) * gamma.bfloat16()  # noqa: E731
        yard[site] = dict(prepass=time_ms(pre), chain_up=time_ms(chain_up),
                          chain_down=time_ms(chain_down),
                          matmul_up=time_ms(lambda: torch.matmul(hn, w1)),
                          matmul_down=time_ms(lambda: torch.matmul(h, w2)), flops=flops)
        del x, hn, h, ref_up, ref_down
        torch.cuda.empty_cache()
    for site, M in SITES.items():
        print(f"{site} site, {M} rows, C {C}, hidden {CH}: ms and TFLOP/s, 20 launches back "
              f"to back")
        for name, r in rows.items():
            t_up, t_down, f_up, f_down = r[site]
            print(f"  {name:24s} up {t_up:.4f} ms {f_up:6.1f}   down {t_down:.4f} ms "
                  f"{f_down:6.1f}")
        y_ = yard[site]
        print(f"  {'pre-pass alone':24s} {y_['prepass']:.4f} ms")
        print(f"  {'library chain':24s} up {y_['chain_up']:.4f} ms   down "
              f"{y_['chain_down']:.4f} ms")
        print(f"  {'cuBLAS product alone':24s} up {y_['matmul_up']:.4f} ms "
              f"{y_['flops'] / y_['matmul_up'] / 1e9:6.1f}   down {y_['matmul_down']:.4f} ms "
              f"{y_['flops'] / y_['matmul_down'] / 1e9:6.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
