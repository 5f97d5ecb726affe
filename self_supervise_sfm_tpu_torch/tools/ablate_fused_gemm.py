"""Where the out-projection's time goes: ablations of the mma.sync GEMM body.

    python3 -m self_supervise_sfm_tpu_torch.tools.ablate_fused_gemm   # one CUDA card

Builds copies of ``csrc/fused_block.cu`` + ``csrc/gemm_core.cuh`` under
``build/ablation/`` with parts of the kernel switched off by a textual patch
(each patch must find its line, or the script fails), and times the
out-projection kernel (merged-heads A, K = 1024, 1024 columns) at the frame
site of the main path (10 x 1374 rows), 20 launches back to back between
CUDA events. (LN+QKV(+RoPE) and the MLP pair run on the wgmma body:
``ablate_gemm_sm90``.) An ablated kernel computes nothing meaningful; only
the unpatched build is checked against the plain version. A patch is taken
out at run time by a condition that is never true (a negative size), so the
compiler cannot remove the code around it.

Reads: "products only" is the mma.sync ceiling of this tiling, "+ fragment
reads" adds ldmatrix, "no copies" the whole kernel fed from stale shared
memory, "no products" the cp.async copies alone.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

from .. import _kernels
from ..ops import fused_qkv as FQ

BATCH, NTOK, HEADS, C = 10, 1374, 16, 1024

NO_EPILOGUE = [("fused_block.cu", "  epilogue(p, acc, m0, n0);",
                "  if (p.M < 0) epilogue(p, acc, m0, n0);")]
NO_COPIES = [("gemm_core.cuh", "    if (kt < KT) {\n      const int slot",
              "    if (kt < KT && nout < 0) {\n      const int slot")]
NO_PRODUCTS = [("gemm_core.cuh",
                "    for (int kk = 0; kk < BK / 16; ++kk) {\n      if (kk + 1",
                "    for (int kk = 0; kk < (K < 0 ? BK / 16 : 0); ++kk) {\n      if (kk + 1")]
NO_FRAGMENT_READS = [
    ("gemm_core.cuh", "        ldsm_x4(af[buf][mt], ta + mt * 16 * LDA + kk * 16);",
     "        { af[buf][mt][0] = af[buf][mt][1] = af[buf][mt][2] = af[buf][mt][3] = lane + kk; }"),
    ("gemm_core.cuh", "        ldsm_x4_trans(bq[buf][np], tb + kk * 16 * LDB + np * 16);",
     "        { bq[buf][np][0] = bq[buf][np][1] = bq[buf][np][2] = bq[buf][np][3] = lane * 3 + kk; }"),
]
VARIANTS = {
    "whole kernel": [],
    "no epilogue": NO_EPILOGUE,
    "no copies": NO_COPIES,
    "no copies, no epilogue (+ fragment reads)": NO_COPIES + NO_EPILOGUE,
    "products only": NO_COPIES + NO_EPILOGUE + NO_FRAGMENT_READS,
    "no products": NO_PRODUCTS,
    "no products, no epilogue (copies only)": NO_PRODUCTS + NO_EPILOGUE,
}


def build(index: int, patches) -> ctypes.CDLL:
    src_dir = Path(_kernels._SRC_DIR)
    out = _kernels.BUILD_DIR.parent / "ablation" / f"v{index}"
    out.mkdir(parents=True, exist_ok=True)
    for name in ("gemm_core.cuh", "fused_block.cu"):
        text = (src_dir / name).read_text()
        for target, old, new in patches:
            if target == name:
                if text.count(old) != 1:
                    raise RuntimeError(f"patch does not apply to {name}: {old!r}")
                text = text.replace(old, new)
        (out / name).write_text(text)
    so = out / "lib.so"
    _kernels._build(so, [out / "fused_block.cu"])
    lib = ctypes.CDLL(str(so))
    fn = lib.sfm_fused_proj_residual
    fn.argtypes = _kernels._SIGNATURES["sfm_fused_proj_residual"]
    fn.restype = ctypes.c_int
    return lib


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_fused_gemm: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    rows = BATCH * NTOK
    x = randn(BATCH, NTOK, C, dtype=torch.bfloat16)
    o = randn(BATCH, HEADS, NTOK, C // HEADS, dtype=torch.bfloat16)
    wp = (randn(C, C) * C**-0.5).bfloat16()
    bp, gamma = randn(C), randn(C)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    flops = 2.0 * rows * C * C
    print(f"{torch.cuda.get_device_name(0)}; rows {rows}, C {C}; {flops / 1e9:.1f} GFLOP a call")
    for index, (name, patches) in enumerate(VARIANTS.items()):
        lib = build(index, patches)

        def proj():
            rc = lib.sfm_fused_proj_residual(o.data_ptr(), x.data_ptr(), wp.data_ptr(),
                                             bp.data_ptr(), gamma.data_ptr(), y.data_ptr(),
                                             BATCH, NTOK, HEADS, stream)
            assert rc == 0, rc

        if not patches:
            proj()
            torch.cuda.synchronize()
            e_proj = float((y.float() - FQ.fused_proj_residual_plain(o, x, wp, bp, gamma)
                            .float()).abs().max())
            print(f"  whole kernel against the plain version: max abs err {e_proj:.4f}")
        ms = time_ms(proj)
        print(f"  {name:42s} out-proj (heads, 1024) {ms:.4f} ms  {flops / ms / 1e9:6.1f} TFLOP/s")
    xf = x.view(rows, C)
    ms = time_ms(lambda: torch.matmul(xf, wp))
    print(f"  {'cuBLAS x @ w_proj (yardstick)':42s} {'':22s} {ms:.4f} ms  "
          f"{flops / ms / 1e9:6.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
