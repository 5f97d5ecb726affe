"""ctypes binding to the native data plane (``cpp/dataplane/dataplane.cpp``).

Port of ``self_supervise_sfm_tpu/native/dataplane.py``: a C++ library for
JPEG / 16-bit PNG decode, Pillow-semantics pad-square bicubic preprocessing
and certainty-weighted correspondence sampling, whose entry points hold no
GIL, so scene loading on a few Python threads gets real core parallelism.

The library is compiled with g++ (it needs the libjpeg / libpng headers) at
first use, from the source in ``cpp/dataplane/`` into
``build/dataplane/libdataplane.so``: nothing is written under ``cpp/``.
:func:`available` says whether it built; the pure-Python pipeline
(``data/preprocess.py``) is the data plane's other choice, picked by the
caller (``IMC2021Scenes(use_native=...)``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "cpp", "dataplane", "dataplane.cpp")
_LIB = os.path.join(_ROOT, "build", "dataplane", "libdataplane.so")
_lock = threading.Lock()
_lib = None
_tried = False


def build(force: bool = False) -> str:
    """Compile the library into ``build/dataplane/`` unless a copy newer
    than the source is there; returns its path."""
    if (
        not force
        and os.path.exists(_LIB)
        and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
    ):
        return _LIB
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    # compile to a private name, then rename: several processes sharing one
    # checkout may race the build, and a partly written .so must never be
    # loaded
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        _SRC, "-o", tmp, "-ljpeg", "-lpng", "-lz",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)
    return _LIB


def _load():
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(build())
            except (OSError, subprocess.CalledProcessError):
                return None
            u8p = ctypes.POINTER(ctypes.c_ubyte)
            f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
            ip = ctypes.POINTER(ctypes.c_int)

            lib.dp_jpeg_info.restype = ctypes.c_int
            lib.dp_jpeg_info.argtypes = [u8p, ctypes.c_size_t, ip, ip]
            lib.dp_jpeg_decode.restype = ctypes.c_int
            lib.dp_jpeg_decode.argtypes = [
                u8p, ctypes.c_size_t,
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ]
            lib.dp_png16_info.restype = ctypes.c_int
            lib.dp_png16_info.argtypes = [u8p, ctypes.c_size_t, ip, ip]
            lib.dp_png16_decode.restype = ctypes.c_int
            lib.dp_png16_decode.argtypes = [u8p, ctypes.c_size_t, u16]
            lib.dp_preprocess_rgb.restype = ctypes.c_int
            lib.dp_preprocess_rgb.argtypes = [
                u8p, ctypes.c_size_t, ctypes.c_int, f32, f32, f32,
            ]
            lib.dp_preprocess_depth.restype = ctypes.c_int
            lib.dp_preprocess_depth.argtypes = [
                u8p, ctypes.c_size_t, ctypes.c_int, f32,
                ctypes.c_void_p, f32, f32,
            ]
            lib.dp_sample_pair.restype = ctypes.c_int
            lib.dp_sample_pair.argtypes = [
                u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
                u8p, ctypes.c_size_t,
                f32, ctypes.c_int, ctypes.c_int,
                f32, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_uint64,
                f32, f32, f32, f32,
            ]
            _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native data plane unavailable: cpp/dataplane/dataplane.cpp did not "
            "build (needs g++ with libjpeg/libpng); pass use_native=False / "
            "--no-native-loader for the pure-python pipeline"
        )
    return lib


def _as_u8p(b: bytes):
    return ctypes.cast(ctypes.c_char_p(b), ctypes.POINTER(ctypes.c_ubyte))


def jpeg_decode(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB (grayscale sources expanded)."""
    lib = _require()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.dp_jpeg_info(_as_u8p(data), len(data), w, h) != 0:
        raise ValueError("bad JPEG")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.dp_jpeg_decode(_as_u8p(data), len(data), out) != 0:
        raise ValueError("JPEG decode failed")
    return out


def png16_decode(data: bytes) -> np.ndarray:
    """16-bit grayscale PNG bytes -> (H, W) uint16."""
    lib = _require()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.dp_png16_info(_as_u8p(data), len(data), w, h) != 0:
        raise ValueError("bad PNG")
    out = np.empty((h.value, w.value), np.uint16)
    if lib.dp_png16_decode(_as_u8p(data), len(data), out) < 0:
        raise ValueError("PNG decode failed")
    return out


def preprocess_rgb(data: bytes, target: int = 518):
    """JPEG bytes -> ((T, T, 3) f32 [0,1], K_to_K_prime, K_prime_to_K)."""
    lib = _require()
    out = np.empty((target, target, 3), np.float32)
    k2kp = np.empty((3, 3), np.float32)
    kp2k = np.empty((3, 3), np.float32)
    if lib.dp_preprocess_rgb(_as_u8p(data), len(data), target, out, k2kp, kp2k) != 0:
        raise ValueError("RGB preprocess failed")
    return out, k2kp, kp2k


def preprocess_depth(
    data: bytes, target: int = 518, want_raw: bool = True
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray, np.ndarray]:
    """u16-mm PNG bytes -> ((T, T) f32 m, raw (H, W) f32 m | None, K mats)."""
    lib = _require()
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.dp_png16_info(_as_u8p(data), len(data), w, h) != 0:
        raise ValueError("bad PNG")
    out = np.empty((target, target), np.float32)
    raw = np.empty((h.value, w.value), np.float32) if want_raw else None
    k2kp = np.empty((3, 3), np.float32)
    kp2k = np.empty((3, 3), np.float32)
    rptr = raw.ctypes.data_as(ctypes.c_void_p) if want_raw else None
    if lib.dp_preprocess_depth(
        _as_u8p(data), len(data), target, out, rptr, k2kp, kp2k
    ) != 0:
        raise ValueError("depth preprocess failed")
    return out, raw, k2kp, kp2k


def sample_pair(
    xpng: bytes, ypng: bytes, cpng: bytes,
    depth_src: np.ndarray, depth_dst: np.ndarray,
    sample_num: int, min_conf: float, seed: int,
):
    """Native decode + certainty-weighted sampling of one RoMa warp pair.

    Returns (src_xy (K, 2), dst_xy (K, 2), src_depth (K,), dst_depth (K,)),
    matching ``data/preprocess.py::sample_correspondence_and_depth``
    semantics (same distribution; a splitmix64 stream instead of numpy's).
    """
    lib = _require()
    depth_src = np.ascontiguousarray(depth_src, np.float32)
    depth_dst = np.ascontiguousarray(depth_dst, np.float32)
    K = sample_num
    src_xy = np.empty((K, 2), np.float32)
    dst_xy = np.empty((K, 2), np.float32)
    src_d = np.empty((K,), np.float32)
    dst_d = np.empty((K,), np.float32)
    rc = lib.dp_sample_pair(
        _as_u8p(xpng), len(xpng), _as_u8p(ypng), len(ypng),
        _as_u8p(cpng), len(cpng),
        depth_src, depth_src.shape[0], depth_src.shape[1],
        depth_dst, depth_dst.shape[0], depth_dst.shape[1],
        K, min_conf, seed, src_xy, dst_xy, src_d, dst_d,
    )
    if rc == -3:
        raise ValueError("No correspondences above min_corres_conf")
    if rc != 0:
        raise ValueError(f"sample_pair failed: {rc}")
    return src_xy, dst_xy, src_d, dst_d
