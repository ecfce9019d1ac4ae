"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface. The library's name carries a hash of the
sources and flags, so an edited source is rebuilt and a built one is reused.
The build directory (``src/repro_torch/build/``) is listed in ``.gitignore``.

Each wrapper counts its launches in :data:`LAUNCHES`, so a run can show that
its path went through the kernels; nothing else touches the counts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["DTYPE_CODES", "LAUNCHES", "KernelError", "build_info", "check",
           "library", "require_cuda", "reset_launches", "sources",
           "stream_of"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# codes of csrc/common.cuh::DType
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: dict[str, int] = {
    "rmsnorm": 0, "flash_attention": 0, "decode_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, w, y, rows, d, eps, dtype, stream
    "xaas_rmsnorm": (_P, _P, _P, _I, _I, _F, _I, _P),
    # q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale,
    # dtype, stream
    "xaas_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _F, _F, _I, _P),
    # q, k, v, lengths, out, B, S, Hq, Hkv, D, window, softcap, scale, dtype,
    # stream
    "xaas_decode_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                              _F, _I, _P),
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
build_info: dict = {}  # seconds, cached, log (ptxas register/smem report)


class KernelError(RuntimeError):
    """A kernel failed to build, was refused at launch, or was handed
    tensors it does not take."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    so = BUILD_DIR / f"libxaas_kernels_{_digest()}.so"
    if so.exists():
        build_info.update(seconds=0.0, cached=True, log="")
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        outs = [(src, proc.communicate()[0], proc.returncode)
                for src, proc in procs]  # every nvcc ends before any raise
        for src, out, rc in outs:
            if rc:
                raise KernelError(f"nvcc failed on {src.name}:\n{out}")
        logs = [f"== {src.name}\n{out}" for src, out, _ in outs]
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_so),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise KernelError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      log="\n".join(logs))
    return so


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error; else count the
    launch."""
    if err:
        raise KernelError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device and is
    contiguous (the kernels compute offsets from dense layouts)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise KernelError(f"{name}: tensors must share one CUDA device, "
                              f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise KernelError(f"{name}: tensors must be contiguous")
