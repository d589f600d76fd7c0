"""Build and load the port's CUDA kernels (`p265_tpu_torch/csrc/*.cu`).

nvcc compiles every source at once, one process per source, and links the
objects into one shared library with a plain C interface, loaded with
ctypes.  The library is named by a hash of the sources and flags and lives
in `p265_tpu_torch/build/`, so a changed source rebuilds and an unchanged
one loads at once.  `library(defines)` builds and loads a second library
with other compile-time constants (profile_scan.py's launch shapes of the
scan kernel); every path of the decoder uses `library()`.  The build runs at the first
kernel launch of a process, never at import: the CPU tests import every
module on machines with no nvcc.  A missing nvcc or a failed build raises;
nothing falls back.

Each C entry point takes raw device pointers (`c_void_p`), `c_int` sizes and
the CUDA stream, launches on that stream without synchronising, and returns
`cudaGetLastError()`; `check` raises when that is not 0.  `LAUNCHES` counts
the launches of each kernel, so a run can show that its main path went
through them.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# sm_90a (not sm_90) keeps Hopper's wgmma/setmaxnreg available to later
# kernels; -Xptxas -v reports registers, shared memory and spills per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # host group table, n_groups, device tables, out, plane, plane pitch,
    # int32 positions, stream
    "p265_itransform_grouped": [_P, _I, _P, _P, _P, ctypes.c_int64, _I,
                                _P],
    # host group table, n_groups, host luma / chroma filters, epilogue,
    # stream
    "p265_mc_grouped": [_P, _I, _P, _P, _I, _P],
    # host bucket table, n_buckets, device starts, stride, k0, k1, plane,
    # pw, int32 coordinates, barrier_only, host angle table, stream
    "p265_scan": [_P, _I, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P],
    # host group table, n_groups, both directions, stream
    "p265_deblock": [_P, _I, _I, _P],
    # host parameter row, stream
    "p265_sao": [_P, _P],
}

LAUNCHES = {"itransform": 0, "mc": 0, "scan": 0, "deblock": 0, "sao": 0}

_lock = threading.Lock()
_libs: dict = {}         # defines -> the loaded library
build_info: dict = {}    # {"path", "seconds", "log"} of library()'s load


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): "
                       "the CUDA kernels of p265_tpu_torch cannot be built")


def _build(defines: tuple[str, ...]) -> tuple[str, str]:
    srcs = _sources()
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    h = hashlib.sha256(" ".join(flags).encode())
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libp265_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc, logs = _nvcc(), []
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in srcs]
    jobs = [[nvcc, *flags, "-c", p, "-o", o] for p, o in zip(srcs, objs)]
    jobs.append([nvcc, "-shared", "-o", tmp, *objs])   # the link, last
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in jobs[:-1]]
    try:
        for cmd, pr in procs:
            out, _ = pr.communicate()
            logs.append(out)
            if pr.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {pr.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
    finally:
        for _, pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    r = subprocess.run(jobs[-1], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {r.returncode}):\n"
                           f"{' '.join(jobs[-1])}\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    for o in objs:
        os.remove(o)
    return so, "".join(logs) + r.stdout + r.stderr


def library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library, built on first use (thread-safe);
    `defines` ("NAME=VALUE", passed to nvcc as -D) build another one."""
    with _lock:
        lib = _libs.get(defines)
        if lib is None:
            t0 = time.perf_counter()
            path, log = _build(defines)
            lib = ctypes.CDLL(path)
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.p265_error_string.argtypes = [ctypes.c_int]
            lib.p265_error_string.restype = ctypes.c_char_p
            if not defines:
                build_info.update(path=path, log=log,
                                  seconds=time.perf_counter() - t0)
            _libs[defines] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if err != 0:
        msg = library().p265_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name}: launch failed: {msg} "
                           f"(cudaError {err})")
