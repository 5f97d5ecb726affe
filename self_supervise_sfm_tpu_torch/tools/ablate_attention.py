"""What each choice of the Hopper attention body (K1, K2) is worth: ablations.

    python3 -m self_supervise_sfm_tpu_torch.tools.ablate_attention   # one CUDA card

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
from .timing import back_to_back_ms

SOURCE = "flash_fwd_sm90.cu"
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


def build_all(variants) -> dict:
    """One shared library a variant, every nvcc started together."""
    text = (Path(_kernels._SRC_DIR) / SOURCE).read_text()
    root = _kernels.BUILD_DIR.parent / "ablation_attention"
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
        # the copy includes sm90_common.cuh from csrc/
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
        for entry in ("sfm_flash_fwd_bf16", "sfm_frame_ctx_fwd_bf16"):
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
        print("ablate_attention: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    libs = build_all(VARIANTS)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
