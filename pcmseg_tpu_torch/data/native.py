"""ctypes binding for the native resampler (numpy fallback if unbuilt).

The C++ sources are the repository's ``native/`` (``resample.cpp``,
``normalize.cpp``, the flags of ``native/Makefile``). This package builds
them into ``build/pcmseg_tpu_torch/libpcmseg_native.so``, apart from the
JAX package's ``native/libpcmseg_native.so``. If the library is missing or
the build toolchain is absent, callers silently use the vectorized-numpy
implementation in pcmseg_tpu_torch/data/resample.py — identical semantics,
just slower on cache-miss preprocessing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_SOURCES = ("resample.cpp", "normalize.cpp")
_CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _lib_path() -> str:
    return os.path.join(_repo_root(), "build", "pcmseg_tpu_torch", "libpcmseg_native.so")


def _try_build(force: bool = False) -> bool:
    src_dir = os.path.join(_repo_root(), "native")
    sources = [os.path.join(src_dir, s) for s in _SOURCES]
    if not all(os.path.exists(s) for s in sources):
        return False
    path = _lib_path()
    try:
        if force and os.path.exists(path):
            os.remove(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp, *sources],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        return os.path.exists(path)
    except Exception:  # noqa: BLE001 — toolchain missing → numpy fallback
        return False


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    fp = ctypes.POINTER(ctypes.c_float)
    for fn in (lib.resample_linear_f32, lib.resample_nearest_f32):
        fn.argtypes = [fp] + [ctypes.c_int64] * 3 + [fp] + [ctypes.c_int64] * 3
        fn.restype = None
    lib.normalize_into.argtypes = [
        ctypes.c_void_p,  # in
        ctypes.c_int64,   # n
        ctypes.c_int,     # in_kind
        ctypes.c_double,  # p_lo
        ctypes.c_double,  # p_hi
        ctypes.c_void_p,  # out
        ctypes.c_int64,   # out_stride (elements)
        ctypes.c_int,     # out_kind
    ]
    lib.normalize_into.restype = ctypes.c_int
    return lib


def get_native_lib(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None:
        return _LIB
    if _TRIED:
        return None
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path) and build_if_missing:
        if not _try_build():
            return None
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        try:
            _LIB = _declare(lib)
        except AttributeError:
            # stale .so predating newer entry points — force-rebuild once
            if not (build_if_missing and _try_build(force=True)):
                return None
            _LIB = _declare(ctypes.CDLL(_lib_path()))
        return _LIB
    except OSError:
        return None


def native_resample(
    data: np.ndarray, target_shape, mode: str = "linear"
) -> Optional[np.ndarray]:
    """Native-path resample; returns None when the library isn't available."""
    lib = get_native_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(data, dtype=np.float32)
    out = np.empty(tuple(int(t) for t in target_shape), dtype=np.float32)
    fn = (
        lib.resample_linear_f32 if mode == "linear" else lib.resample_nearest_f32
    )
    fp = ctypes.POINTER(ctypes.c_float)
    fn(
        src.ctypes.data_as(fp), *[ctypes.c_int64(s) for s in src.shape],
        out.ctypes.data_as(fp), *[ctypes.c_int64(s) for s in out.shape],
    )
    return out


_IN_KINDS = {"float32": 0, "int16": 1, "uint16": 2, "float64": 3}


def _out_kind(dtype: np.dtype) -> Optional[int]:
    if dtype == np.float32:
        return 0
    # bfloat16 without importing ml_dtypes here (it may be absent on pure
    # host tooling); match by name, which ml_dtypes registers
    if dtype.name == "bfloat16":
        return 1
    return None


def native_normalize_into(
    data: np.ndarray,
    p_lo: float,
    p_hi: float,
    out: np.ndarray,
    offset: int = 0,
    stride: int = 1,
) -> bool:
    """Fused percentile-normalize of ``data`` into a strided slot of ``out``.

    Writes ``(clip(x, lo, hi) - lo) / (hi - lo)`` — (lo, hi) being the
    (p_lo, p_hi) percentiles of ``data`` (numpy 'linear' method; 0/100 are
    exact min/max, so minmax mode is ``p_lo=0, p_hi=100``) — to
    ``out.ravel()[offset + i*stride]``. One C++ pass replaces numpy's
    percentile/clip/scale/stack/cast chain (~5 full-buffer copies per
    modality on the serving host path — BENCH.md configs[4]).

    ``out`` must be C-contiguous float32 or bfloat16 with room for
    ``offset + data.size*stride`` elements. Returns False (nothing
    written) when the native library or dtype support is unavailable —
    callers fall back to resample.normalize_intensity.
    """
    lib = get_native_lib()
    if lib is None:
        return False
    data = np.asarray(data)
    in_kind = _IN_KINDS.get(data.dtype.name)
    ok = _out_kind(out.dtype)
    if in_kind is None or ok is None or not out.flags.c_contiguous:
        return False
    if not data.flags.c_contiguous:
        data = np.ascontiguousarray(data)
    n = int(data.size)
    if offset < 0 or stride < 1 or offset + (n - 1) * stride >= out.size:
        return False
    rc = lib.normalize_into(
        ctypes.c_void_p(data.ctypes.data),
        ctypes.c_int64(n),
        ctypes.c_int(in_kind),
        ctypes.c_double(float(p_lo)),
        ctypes.c_double(float(p_hi)),
        ctypes.c_void_p(out.ctypes.data + offset * out.dtype.itemsize),
        ctypes.c_int64(stride),
        ctypes.c_int(ok),
    )
    return rc == 0
