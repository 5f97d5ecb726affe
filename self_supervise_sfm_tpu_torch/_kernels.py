"""Build and load the hand-written CUDA kernels under ``csrc/``.

Every ``*.cu`` in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into ONE shared
library with a plain C interface under ``build/kernels/``, named by a hash
of the sources, so a changed source rebuilds and an unchanged one loads the
cached library. The library is loaded with ``ctypes``: each entry takes its
pointers and the stream as ``c_void_p`` and returns ``cudaGetLastError()``
after its launch, which :func:`launch` turns into an exception.

Nothing here runs at import: the build happens on the first CUDA call of a
kernel wrapper. Nothing is downloaded; if ``nvcc`` is missing or a source
does not compile, the call fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

_PKG = Path(__file__).resolve().parent
_SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_CFLAGS = ["-O3", "-std=c++17", _ARCH, "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry -> argtypes (every pointer and the stream as c_void_p: ctypes would
# otherwise pass a Python int as a 32-bit int and cut the pointer)
_SIGNATURES: Dict[str, List] = {
    "sfm_flash_fwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "sfm_frame_ctx_fwd_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # K1m on the same body: bh, nq, nk, n_ctx, frame_size, num_frames
    "sfm_flash_fwd_reloc_sm90": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # the layer stride of the stacked cache is a 64-bit element count
    "sfm_frame_ctx_kv2_fwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _F, _P],
    # the fp32 forms of K1, K2 and K2p on the FFMA body (flash_fwd_f32.cu):
    # the bf16 entries' arguments
    "sfm_flash_fwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "sfm_frame_ctx_fwd_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "sfm_frame_ctx_kv2_fwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _F, _P],
    # K1m in fp32 on the same body: the bf16 entry's arguments
    "sfm_flash_fwd_reloc_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # the same four at head dim 128 on the same body: the same arguments
    "sfm_flash_fwd_d128_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "sfm_frame_ctx_fwd_d128_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "sfm_frame_ctx_kv2_fwd_d128_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _F, _P],
    "sfm_flash_fwd_reloc_d128_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # which kernel of the fp32 body (0 K1, 1 K2, 2 K2p, 3 K1m; 4-7 the same at
    # head dim 128), int[8] out
    "sfm_flash_fwd_f32_info": [_I, _P],
    # B9 on the Hopper backward body: q, k, v, do, lse, delta, outputs; bh,
    # nq, nk; scale * log2(e), scale
    "sfm_flash_bwd_dq_sm90": [_P] * 7 + [_I] * 3 + [_F, _F, _P],
    "sfm_flash_bwd_dkv_sm90": [_P] * 8 + [_I] * 3 + [_F, _F, _P],
    # B9 under a RelocMask on the same body: bh, nq, nk, n_ctx, frame_size
    "sfm_flash_bwd_dq_reloc_sm90": [_P] * 7 + [_I] * 5 + [_F, _F, _P],
    "sfm_flash_bwd_dkv_reloc_sm90": [_P] * 8 + [_I] * 5 + [_F, _F, _P],
    # the fp32 forms of B9 on the FFMA backward body (flash_bwd_f32.cu): the
    # bf16 entries' arguments
    "sfm_flash_bwd_dq_f32": [_P] * 7 + [_I] * 3 + [_F, _F, _P],
    "sfm_flash_bwd_dkv_f32": [_P] * 8 + [_I] * 3 + [_F, _F, _P],
    "sfm_flash_bwd_dq_reloc_f32": [_P] * 7 + [_I] * 5 + [_F, _F, _P],
    "sfm_flash_bwd_dkv_reloc_f32": [_P] * 8 + [_I] * 5 + [_F, _F, _P],
    # the same four at head dim 128 on the same body: the same arguments
    "sfm_flash_bwd_dq_d128_f32": [_P] * 7 + [_I] * 3 + [_F, _F, _P],
    "sfm_flash_bwd_dkv_d128_f32": [_P] * 8 + [_I] * 3 + [_F, _F, _P],
    "sfm_flash_bwd_dq_reloc_d128_f32": [_P] * 7 + [_I] * 5 + [_F, _F, _P],
    "sfm_flash_bwd_dkv_reloc_d128_f32": [_P] * 8 + [_I] * 5 + [_F, _F, _P],
    # which kernel of the fp32 backward body (0 dq, 1 dk/dv, 2 and 3 their
    # RelocMask forms; 4-7 the same at head dim 128), int[8] out
    "sfm_flash_bwd_f32_info": [_I, _P],
    # K1, K2, K2p and K1m at head dim 128 on the same body: the head-dim-64
    # entries' arguments
    "sfm_flash_fwd_d128_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "sfm_frame_ctx_fwd_d128_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "sfm_frame_ctx_kv2_fwd_d128_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _F,
                                        _P],
    "sfm_flash_fwd_reloc_d128_sm90": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # which kernel of the sm90 attention body (0 K1, 1 K2, 2 K2p, 3 K1m; 4-7
    # the same at head dim 128), int[8] out
    "sfm_attention_sm90_info": [_I, _P],
    # B9 at head dim 128 on the same body: the head-dim-64 entries' arguments
    "sfm_flash_bwd_dq_d128_sm90": [_P] * 7 + [_I] * 3 + [_F, _F, _P],
    "sfm_flash_bwd_dkv_d128_sm90": [_P] * 8 + [_I] * 3 + [_F, _F, _P],
    "sfm_flash_bwd_dq_reloc_d128_sm90": [_P] * 7 + [_I] * 5 + [_F, _F, _P],
    "sfm_flash_bwd_dkv_reloc_d128_sm90": [_P] * 8 + [_I] * 5 + [_F, _F, _P],
    # which kernel of the sm90 backward body (0 dq, 1 dk/dv, 2 and 3 their
    # RelocMask forms; 4-7 the same at head dim 128), int[8] out
    "sfm_flash_bwd_sm90_info": [_I, _P],
    # x, add, out; out_bf16, n_img, img_chunk, H, W, C, H2, W2
    "sfm_resize_bilinear_ac": [_P, _P, _P] + [_I] * 8 + [_P],
    # LN+QKV(+RoPE), the out-projection and the MLP pair on the wgmma / TMA
    # GEMM body (gemm_sm90.cu): the layer-normed ones take an (M, C) bf16
    # scratch for the normalised rows; LN+QKV(+RoPE): batch, ntok, C, the
    # heads it computes (all, or a rank's head shard), eps; the
    # out-projection: batch, ntok, heads
    "sfm_ln_qkv_rope_sm90": [_P] * 15 + [_I, _I, _I, _I, _F, _P],
    "sfm_ln_qkv_sm90": [_P] * 9 + [_I, _I, _I, _I, _F, _P],
    "sfm_proj_residual_sm90": [_P] * 6 + [_I, _I, _I, _P],
    "sfm_mlp_up_sm90": [_P] * 7 + [_I, _I, _I, _F, _P],
    "sfm_mlp_down_sm90": [_P] * 6 + [_I, _I, _I, _P],
    "sfm_ln_rows_bf16": [_P] * 4 + [_I, _I, _F, _P],
    "sfm_gemm_sm90_probe": [_P] * 3 + [_I, _I, _I, _P],
    # LN+QKV+RoPE, LN+QKV and the out-projection at head dim 128 on the same
    # body: the head-dim-64 entries' arguments
    "sfm_ln_qkv_rope_d128_sm90": [_P] * 15 + [_I, _I, _I, _I, _F, _P],
    "sfm_ln_qkv_d128_sm90": [_P] * 9 + [_I, _I, _I, _I, _F, _P],
    "sfm_proj_residual_d128_sm90": [_P] * 6 + [_I, _I, _I, _P],
    # which kernel of the GEMM body (0 up, 1 down, 2 probe, 3 LN, 4 LN+QKV+RoPE,
    # 5 LN+QKV, 6 out-proj; 7-9 the last three at head dim 128), int[10] out
    "sfm_gemm_sm90_info": [_I, _P],
    # the fp32 forms of the five on the FFMA GEMM body (gemm_f32.cu): the
    # bf16 entries' arguments, the scratch (M, C) fp32
    "sfm_ln_qkv_rope_f32": [_P] * 15 + [_I, _I, _I, _I, _F, _P],
    "sfm_ln_qkv_f32": [_P] * 9 + [_I, _I, _I, _I, _F, _P],
    "sfm_proj_residual_f32": [_P] * 6 + [_I, _I, _I, _P],
    "sfm_mlp_up_f32": [_P] * 7 + [_I, _I, _I, _F, _P],
    "sfm_mlp_down_f32": [_P] * 6 + [_I, _I, _I, _P],
    "sfm_ln_rows_f32": [_P] * 4 + [_I, _I, _F, _P],
    # LN+QKV+RoPE, LN+QKV and the out-projection at head dim 128 on the same
    # body: the head-dim-64 entries' arguments
    "sfm_ln_qkv_rope_d128_f32": [_P] * 15 + [_I, _I, _I, _I, _F, _P],
    "sfm_ln_qkv_d128_f32": [_P] * 9 + [_I, _I, _I, _I, _F, _P],
    "sfm_proj_residual_d128_f32": [_P] * 6 + [_I, _I, _I, _P],
    # which kernel of the fp32 GEMM body (0 LN+QKV+RoPE, 1 LN+QKV, 2 out-proj,
    # 3 up, 4 down, 5 LN; 6-8 the first three at head dim 128), int[10] out
    "sfm_gemm_f32_info": [_I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc/ptxas output of the last build made by this process
# seconds from the start of the last build made by this process to the end of
# each source's nvcc (they run side by side), and to the end of the link
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> List[Path]:
    return sorted(_SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(_CFLAGS).encode())
    for p in sorted(_SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(so: Path, sources: List[Path]) -> None:
    global build_log
    nvcc = _nvcc()
    obj_dir = so.parent / (so.stem + "_obj")
    obj_dir.mkdir(parents=True, exist_ok=True)
    objs = [obj_dir / (s.stem + ".o") for s in sources]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *_CFLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(sources, objs)
    ]
    outs: Dict[str, str] = {}

    def wait(s: Path, p: subprocess.Popen) -> None:
        outs[s.name] = p.communicate()[0]
        build_seconds[s.name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=sp) for sp in zip(sources, procs)]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    logs = [f"== {s.name}\n{outs[s.name]}" for s in sources]
    failed = [s.name for s, p in zip(sources, procs) if p.returncode != 0]
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    res = subprocess.run(
        [nvcc, _ARCH, "-shared", *map(str, objs), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    build_seconds["link"] = time.perf_counter() - t0
    os.replace(tmp, so)
    (so.parent / (so.stem + ".log")).write_text(build_log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            so = BUILD_DIR / f"libsfm_kernels_{_digest()}.so"
            if not so.exists():
                _build(so, sources)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call C entry ``name``; raise if its launch reported a CUDA error."""
    rc = getattr(library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
