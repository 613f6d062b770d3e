"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each ``<name>.cu`` beside this file compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes), for ``sm_90a``, into ``galah_tpu_torch/_build/``.
The library's file name carries the content hash of the source and of
every header (``*.cuh``) beside it, so an unchanged source is built
once per checkout and an edited source or header anew.
All requested sources compile in parallel, one ``nvcc`` each; with
``--trace-events`` each build is a span of category ``nvcc``, and its
seconds are the kernel's ``compile_wall_s`` in the run report
(``obs/profile.py``).

A build failure raises with nvcc's output; nothing falls back.

``python -m galah_tpu_torch.kernels.build --ptxas [names]`` compiles
the named kernels (default: all) once more with ``-Xptxas -v`` and
prints each kernel's registers, shared memory and spills.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from typing import Dict, Iterable

from galah_tpu_torch.obs import profile, trace
from galah_tpu_torch.timing import Stopwatch

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signature of each library's launch function: (name, argtypes)
SIGNATURES = {
    "window_hits": ("window_hits_launch", [_P, _I, _L, _I, _P, _P]),
    "tile_stats": ("tile_stats_launch", [_P, _P, _I, _I, _I, _I, _I,
                                         _P, _P, _P]),
    "fused_sketch": ("fused_sketch_launch", [_P, _P, _L, _P, _P, _I, _I, _I,
                                             _P, _P]),
    "pairlist": ("pairlist_launch", [_P, _I, _P, _P, _P, _I, _I, _P, _P,
                                     _P]),
    "hll_union": ("hll_union_launch", [_P, _P, _I, _I, _I, _I, _P, _P,
                                       _P, _P, _P]),
    "murmur3_k21": ("murmur3_k21_launch", [_P, _P, _L, _L, _L, _P, _P]),
    "positional_hashes": ("positional_hashes_launch", [_P, _P, _L, _L, _L,
                                                       _I, _P, _P]),
    "slab_fold": ("slab_fold_launch", [_P, _I, _P, _I, _L, _I, _I, _I, _I,
                                       _P, _I, _I, _P, _P]),
}

# the further C functions of a library, bound beside its launch
# function: name -> [(function, argtypes)]
MORE_SIGNATURES = {
    "tile_stats": [
        ("tile_stats_gather_launch", [_P, _I, _P, _P, _P, _P, _P, _I, _I,
                                      _P, _P, _P])],
    "positional_hashes": [
        ("positional_hashes_group_launch", [_P, _P, _L, _P, _L, _L, _I, _L,
                                            _P]),
        ("positional_hashes_tile", [])],
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the kernels")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_HERE) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(_HERE, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = tuple(SIGNATURES)) -> float:
    """Compile every named kernel whose library is not built yet, all
    at once; returns the seconds spent."""
    watch = Stopwatch()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(_HERE, f"{name}.cu")]
        # galah-lint: ignore[GL701] the nvcc span's start, on trace's clock
        started = time.perf_counter()
        procs.append((name, out, tmp, started, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, started, proc in procs:
        log, _ = proc.communicate()
        # the span ends when this build is reaped, after the ones
        # started before it
        # galah-lint: ignore[GL701] the span's length, trace's own input
        seconds = time.perf_counter() - started
        trace.emit_complete(f"nvcc {name}.cu", started, seconds, cat="nvcc")
        # the run that builds a kernel is charged its build
        profile.profiled(name).add_compile(seconds)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return watch.seconds()


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        for fn_name, argtypes in [SIGNATURES[name],
                                  *MORE_SIGNATURES.get(name, ())]:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


class KernelLaunchError(RuntimeError):
    """A launch function returned a nonzero ``cudaError_t``, kept as
    `cuda_error`: the dispatch supervisor retries only 2
    (``cudaErrorMemoryAllocation``; ``resilience/policy.is_retryable``)."""

    def __init__(self, name: str, cuda_error: int) -> None:
        super().__init__(
            f"{name} kernel launch failed: cudaError_t {cuda_error}")
        self.kernel = name
        self.cuda_error = int(cuda_error)


def check(name: str, err: int) -> None:
    """Raise ``KernelLaunchError`` on a nonzero cudaError_t from a launch
    function."""
    if err != 0:
        raise KernelLaunchError(name, err)


def ptxas(name: str) -> str:
    """ptxas's report (registers, shared memory, spills) of kernel
    `name`, from a compile to a throwaway object."""
    out = os.path.join(BUILD_DIR, f"ptxas-{name}.o")
    os.makedirs(BUILD_DIR, exist_ok=True)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
         os.path.join(_HERE, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, check=False)
    if os.path.exists(out):
        os.remove(out)
    log = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    return log


if __name__ == "__main__":
    args = sys.argv[1:]
    if not args or args[0] != "--ptxas":
        sys.exit("usage: python -m galah_tpu_torch.kernels.build --ptxas "
                 "[kernel ...]")
    for kernel in args[1:] or SIGNATURES:
        print(f"== {kernel}.cu (sm_90a)")
        print(ptxas(kernel).strip())
