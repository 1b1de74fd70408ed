"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each kernel source compiles with nvcc into a shared library with a plain C
entry point, loaded with ctypes.  Libraries go to build/compound_ray_tpu_torch/
next to the package, named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads the library already built; nvcc's
log (ptxas -v: registers, spills) is kept beside the library.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "compound_ray_tpu_torch")
# no --use_fast_math: the tracers' padding columns mask themselves only
# under IEEE division and NaN comparisons
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# what the last build of each kernel printed and took: {name: (seconds, log)}
build_info: Dict[str, tuple] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the port's CUDA "
        "kernels are built from csrc/ with the CUDA toolkit")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless a library of the same source and flags
    exists; return the library's path."""
    return build_many([name])[name]


def build_many(names) -> Dict[str, str]:
    """build() for several kernels, with one nvcc process per source, all
    started together; returns {name: library path}."""
    paths: Dict[str, str] = {}
    running = []
    for name in names:
        src = os.path.join(CSRC_DIR, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        lib = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
        paths[name] = lib
        if os.path.isfile(lib):
            log = "cached: " + lib
            if os.path.isfile(lib + ".log"):  # what nvcc said when it built
                with open(lib + ".log") as f:
                    log += "\n" + f.read()
            build_info.setdefault(name, (0.0, log))
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, src, tmp, lib, proc, time.perf_counter()))
    failed = []
    for name, src, tmp, lib, proc, t0 in running:
        log = proc.communicate()[0].strip()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                          f"{log}")
            continue
        with open(lib + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
        build_info[name] = (seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _load(name: str, entries, argtypes) -> ctypes.CDLL:
    """csrc/<name>.cu's library with its C entry points' signature (one
    name, or a tuple of names that share it) declared; built and loaded
    once per process."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        for entry in (entries,) if isinstance(entries, str) else entries:
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int


def packed_tracer_lib() -> ctypes.CDLL:
    """The K1 library (csrc/packed_tracer.cu): cr_packed_tracer (16-feature
    rays) and cr_packed_tracer_affine (8-feature affine rays)."""
    return _load("packed_tracer", ("cr_packed_tracer",
                                   "cr_packed_tracer_affine"),
                 [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _P])


def cluster_tracer_lib() -> ctypes.CDLL:
    """The K2 library (csrc/cluster_tracer.cu)."""
    return _load("cluster_tracer", "cr_cluster_tracer",
                 [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])


def rows_occlusion_lib() -> ctypes.CDLL:
    """The K3 library (csrc/rows_occlusion.cu)."""
    return _load("rows_occlusion", "cr_rows_occlusion",
                 [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong,
                  _P])


def refine_mask_lib() -> ctypes.CDLL:
    """The planning refine's library (csrc/refine_mask.cu)."""
    return _load("refine_mask", "cr_refine_mask",
                 [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                  _P])


def shade_means_lib() -> ctypes.CDLL:
    """The frame core's unlit shading and means (csrc/shade_means.cu)."""
    return _load("shade_means", "cr_shade_means",
                 [_P, _P, ctypes.c_longlong, _P, _P, _I, _I, _P, _P, _P, _P,
                  _P, _P, _P, ctypes.c_longlong, _I, _I, _P, _P, _P, _P, _P,
                  ctypes.c_float, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P])


def ray_features_lib() -> ctypes.CDLL:
    """The frame core's ray generation (csrc/ray_features.cu)."""
    return _load("ray_features", "cr_ray_features",
                 [_P, _P, _P, _P, ctypes.c_longlong, _P, ctypes.c_longlong,
                  _I, _I, _I, _I, _I, _P, _P, _P])


def cache_cull_lib() -> ctypes.CDLL:
    """The far-field cache's cull and shortlist (csrc/cache_cull.cu)."""
    return _load("cache_cull", "cr_cache_shortlist",
                 [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                  _P, _P])


def probe_step_lib() -> ctypes.CDLL:
    """The K4 and K5 library (csrc/probe_step.cu)."""
    return _load("probe_step", "cr_probe_step",
                 [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_longlong,
                  ctypes.c_longlong, _P])


def microbench_k_lib() -> ctypes.CDLL:
    """The K6 library (csrc/microbench_k.cu)."""
    return _load("microbench_k", "cr_dot_bench",
                 [_P, _P, _P, _P, _I, _I, _I, _I, _P])
