"""The binding of the package's native code: build, load, check, launch and
count.

Sources are compiled into ``hikari_tpu_torch/build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, of the
headers beside it and of the compiler command, so an edited source or
header is rebuilt and a stale library is never loaded. The output is
written to a temporary name and renamed into place, so concurrent first
uses do not see a half-written file.

A hand-written CUDA kernel is declared once, by its library name, source
and C symbols (``library``), launched through ``launch``, which raises on
a CUDA error and counts the launch in the launch record, and has a plain
PyTorch version beside it that runs only on CPU tensors. The record is
always on: ``launches`` counts each kernel's launches and
``plain_cuda_runs`` each plain sweep's runs on CUDA tensors (only callers
that compare it with its kernel run one there), both since
``reset_counts()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE / "build"
CSRC = PACKAGE / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# the launch record: kernel name (a C symbol without its "hikari_") -> count
launches: Counter = Counter()
plain_cuda_runs: Counter = Counter()

_loaded: dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    """Zero the launch record."""
    launches.clear()
    plain_cuda_runs.clear()


def source_digest(source: Path, command: list[str]) -> str:
    """Hash of `source`, of every header (``*.cuh``) in its directory, which
    it may include, and of the compiler command."""
    h = hashlib.sha256()
    for path in [source, *sorted(source.parent.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(command).encode())
    return h.hexdigest()[:12]


def build_shared_library(name: str, source: Path, command: list[str],
                         timeout: float = 600.0) -> Path:
    """Compile `source` with `command` (compiler and flags, without the
    output and input paths) into lib<name>_<hash>.so; return its path.
    Raises subprocess.CalledProcessError (with the compiler's output in
    .stderr), OSError or subprocess.TimeoutExpired on failure."""
    digest = source_digest(source, command)
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([*command, "-o", str(tmp), str(source)], check=True,
                       capture_output=True, text=True, timeout=timeout)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the kernels are built with the CUDA toolkit at "
                       "first use on a CUDA tensor")


def library(name: str, source: Path, signatures: dict, command: list[str] | None = None,
            restype=ctypes.c_int, timeout: float = 600.0) -> ctypes.CDLL:
    """Build (at first use) and load `source` as lib<name>, with nvcc and
    NVCC_FLAGS unless `command` is given; loaded once a process. signatures:
    {C symbol: argtypes}, each returning `restype`. A compiler error raises
    RuntimeError with the compiler's output; a missing compiler OSError."""
    lib = _loaded.get(name)
    if lib is None:
        command = command or [nvcc(), *NVCC_FLAGS]
        try:
            path = build_shared_library(name, source, command, timeout)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"{Path(command[0]).name} failed to build {source}:\n"
                               f"{e.stderr}") from e
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in signatures.items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, restype
        _loaded[name] = lib
    return lib


def kernel_attributes(symbol, kernels) -> dict:
    """{kernel: (registers a thread, spill bytes a thread, resident blocks
    per SM)} as the CUDA runtime reports them, from a C symbol that fills
    int[3 * len(kernels)] in the order of `kernels`."""
    out = (ctypes.c_int * (3 * len(kernels)))()
    err = symbol(ctypes.addressof(out))
    if err:
        raise RuntimeError(f"{symbol.__name__} failed: cudaError {err}")
    return {k: tuple(out[3 * i:3 * i + 3]) for i, k in enumerate(kernels)}


def check(name, x, dtype, shape, device) -> None:
    """Raise ValueError unless tensor x is contiguous, of `dtype`, on
    `device` and, where shape is not None, of that shape."""
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {x.dtype} on {x.device} (contiguous="
                         f"{x.is_contiguous()})")
    if shape is not None and tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")


def stream(device) -> int:
    """The current CUDA stream of `device`, as a kernel launch takes it."""
    return torch.cuda.current_stream(device).cuda_stream


def launch(symbol, *args) -> None:
    """Call the C symbol, which launches a kernel and returns its cudaError;
    raise on a nonzero one, else count a launch of the kernel."""
    err = symbol(*args)
    if err:
        raise RuntimeError(f"{symbol.__name__} launch failed: cudaError {err}")
    launches[symbol.__name__.removeprefix("hikari_")] += 1
