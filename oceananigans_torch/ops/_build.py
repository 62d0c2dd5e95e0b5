"""Build the CUDA kernels of ``oceananigans_torch/csrc`` and load them.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` file for Hopper
(``sm_90a``), one process per source, all started together, and links the
objects into one shared library with a plain C interface, in
``build/oceananigans_torch/`` beside the package (git ignores ``build/``).
The library's name carries a hash of the sources, the headers they include
(``csrc/*.h``) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. It is loaded with
``ctypes``; every entry point launches on the stream it is given and returns
``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "oceananigans_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
#: C entry points (without the _f32/_f64 suffix) and their argument types;
#: every one ends with the stream
SIGNATURES = {
    "ot_c2_tendency": [_P] * 6 + [_I] * 3 + [_D] * 3 + [_I] * 4 + [_P],
    "ot_c2_ab2": [_P] * 9 + [_I] * 3 + [_D] * 5 + [_P],
    "ot_c2_science_ab2": [_P] * 12 + [_I] * 4 + [_D] * 6 + [_I] + [_P],
    "ot_pressure_correction": [_P] * 7 + [_I] * 3 + [_D] * 4 + [_P],
    "ot_poisson_middle": [_P] * 8 + [_I] * 3 + [_P],
    "ot_weno5_tendency": [_P] * 6 + [_I] * 3 + [_D] * 4 + [_P],
    "ot_weno5_tracers": [_P] * 5 + [_I] * 4 + [_D] * 4 + [_P],
    "ot_weno5_ab2": [_P] * 9 + [_I] * 3 + [_D] * 6 + [_P],
    "ot_weno5_science_ab2": [_P] * 12 + [_I] * 4 + [_D] * 7 + [_I] + [_P],
    "ot_sw_rk3_stage": [_P] * 9 + [_I] * 6 + [_D] * 5 + [_P],
    "ot_weno_tracer_march": [_P] * 5 + [_I] * 4 + [_P] + [_I] * 5 + [_D, _P],
    "ot_vi_march": [_P] * 5 + [_I] * 3 + [_P] + [_I] * 9 + [_D] * 4 + [_P],
    "ot_generic_momentum": [_P] * 6 + [_I] * 7 + [_D] * 7 + [_I] * 4 + [_P],
}

_lib = None
#: seconds the last build took (0 when a cached library was loaded), and
#: nvcc's report of registers and shared memory per kernel
build_seconds = 0.0
build_log = ""


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "kernels of oceananigans_torch need nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path():
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources + sorted(SOURCE_DIR.glob("*.h")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return sources, BUILD_DIR / f"liboceananigans_torch_{h.hexdigest()[:16]}.so"


def load():
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    sources, path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        t0 = time.perf_counter()
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([_nvcc(), *FLAGS, "-c", "-o", str(obj),
                              str(src)] for src, obj in zip(sources, objs))]
        logs, failed = [], []
        for cmd, proc in procs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{logs[-1]}")
        build_log = "".join(logs)
        if not failed:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            build_log += res.stdout + res.stderr
            if res.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        build_seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, path)
        (BUILD_DIR / "nvcc.log").write_text(build_log)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.ot_error_string.argtypes = [ctypes.c_int]
    lib.ot_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def launch(name, dtype, device, *args):
    """Call entry point ``name`` for ``dtype`` on ``device``'s current stream
    and raise if the launch was refused."""
    lib = load()
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name + suffix)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}{suffix} failed to launch: CUDA error "
                           f"{err} ({lib.ot_error_string(err).decode()})")
