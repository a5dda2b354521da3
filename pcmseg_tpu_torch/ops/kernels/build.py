"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own nvcc
process, all started together, and the objects are linked into one shared
library with a plain C interface, under ``build/pcmseg_tpu_torch/`` at the
repository root, on first use. The library's file name carries a hash of the
sources, headers and flags, so a changed source builds anew and an unchanged
one is reused. A failed build raises with nvcc's output. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "pcmseg_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers():
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
            "are built from source on the machine with the GPU"
        )
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpcmseg_kernels-{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels if the library for these sources is missing.

    Returns ``{"path", "seconds", "cached"}``.
    """
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objects, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f".{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objects.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        for cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
    except BaseException:
        for _, other in procs:  # stop the compiles still running
            other.kill()
            other.wait()
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return {"path": str(path), "seconds": seconds, "cached": False}


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pcmseg_conv3x3x3_clusters.argtypes = [i, ctypes.POINTER(i)]
        lib.pcmseg_conv3x3x3_clusters.restype = i
        lib.pcmseg_conv3x3x3_plan.argtypes = [i, i, i, i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(ll)]
        lib.pcmseg_conv3x3x3_plan.restype = i
        lib.pcmseg_conv3x3x3_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, i]
        lib.pcmseg_conv3x3x3_bf16.restype = i
        lib.pcmseg_conv3x3x3_f16.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, i]
        lib.pcmseg_conv3x3x3_f16.restype = i
        lib.pcmseg_conv3x3_dw_workspace_bytes.argtypes = [i, i, i, i, i, i, i]
        lib.pcmseg_conv3x3_dw_workspace_bytes.restype = ll
        lib.pcmseg_conv3x3_dw_bf16.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, p, i]
        lib.pcmseg_conv3x3_dw_bf16.restype = i
        lib.pcmseg_conv3x3_dw_f16.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, p, i]
        lib.pcmseg_conv3x3_dw_f16.restype = i
        lib.pcmseg_f16_scale_exponent.argtypes = [i]
        lib.pcmseg_f16_scale_exponent.restype = i
        lib.pcmseg_conv3x3x3_f32_workspace_bytes.argtypes = [i, i, i, i, i, i, i]
        lib.pcmseg_conv3x3x3_f32_workspace_bytes.restype = ll
        lib.pcmseg_conv3x3x3_f32.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, i, p, i]
        lib.pcmseg_conv3x3x3_f32.restype = i
        lib.pcmseg_conv3x3_dw_f32_workspace_bytes.argtypes = [i, i, i, i, i, i, i]
        lib.pcmseg_conv3x3_dw_f32_workspace_bytes.restype = ll
        lib.pcmseg_conv3x3_dw_f32.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, p, i]
        lib.pcmseg_conv3x3_dw_f32.restype = i
        d, f = ctypes.c_double, ctypes.c_float
        lib.pcmseg_batchnorm_scratch_bytes.argtypes = []
        lib.pcmseg_batchnorm_scratch_bytes.restype = ll
        lib.pcmseg_batchnorm_stats.argtypes = [i, p, ll, i, p, ll, p, p, i]
        lib.pcmseg_batchnorm_stats.restype = i
        lib.pcmseg_batchnorm_relu.argtypes = [i, p, p, ll, i, p, p, p, d, d, i, p, p, p, p, f, f, f, p, i]
        lib.pcmseg_batchnorm_relu.restype = i
        lib.pcmseg_batchnorm_grad_sums.argtypes = [i, p, p, ll, i, p, i, p, ll, p, p, i]
        lib.pcmseg_batchnorm_grad_sums.restype = i
        lib.pcmseg_batchnorm_dx.argtypes = [i, p, p, p, ll, i, p, p, p, d, i, p, i]
        lib.pcmseg_batchnorm_dx.restype = i
        lib.pcmseg_cuda_error_string.argtypes = [i]
        lib.pcmseg_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
