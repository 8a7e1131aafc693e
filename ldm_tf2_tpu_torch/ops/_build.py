"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each source in ``ldm_tf2_tpu_torch/csrc/`` is compiled on first use into
``build/ldm_tf2_tpu_torch/<name>-<hash>.so`` at the repository root, where
the hash covers the source text, the shared headers (``csrc/*.cuh``) and
the compiler flags, so an edited source is rebuilt and an unchanged one is
reused.  The shared libraries have a plain C interface (no PyTorch
headers), which keeps a build to seconds.  Nothing here runs at import
time.  Also the wrappers' shared checks: launch errors and differentiation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ldm_tf2_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "need the CUDA toolkit"
        )
    return path


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to; the name's hash covers the source,
    every shared header in ``csrc/`` and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for source in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, source), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names) -> dict[str, float]:
    """Compile every named source that has no up-to-date library, with one
    nvcc process per source, all started together.  Returns the seconds
    each build took (0.0 for a library that was already built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    seconds = {}
    running = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, start in running:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _LOADED[name] = lib
    return lib


_ENTRIES: dict = {}


def entry(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with its argument types
    set once (the wrappers run once per kernel call, and their host time is
    paid before the kernel starts); it returns a cudaError_t as an int."""
    fn = _ENTRIES.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[symbol] = fn
    return fn


_INT_ARRAYS: dict = {}


def int_array(values: tuple) -> ctypes.Array:
    """``values`` as a C int array, made once per distinct tuple: a
    kernel's geometry argument, passed on every call."""
    arr = _INT_ARRAYS.get(values)
    if arr is None:
        arr = _INT_ARRAYS[values] = (ctypes.c_int * len(values))(*values)
    return arr


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def needs_grad(*tensors) -> bool:
    """True when autograd is recording and an input requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


def refuse_grad(mode: str, *tensors) -> None:
    """The int8 serving kernels have no backward: under differentiation
    they raise, as the JAX package's ``_require_exact_forward`` does,
    instead of returning a result with no gradient."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{mode} is a sampling-only serving mode and does not support "
            "differentiation; disable it for training."
        )
