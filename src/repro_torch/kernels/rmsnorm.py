"""RMSNorm: wrapper around the Hopper kernel in ``csrc/rmsnorm.cu``.

Replaces the JAX package's Pallas kernel ``kernels/rmsnorm.py::rmsnorm``.
A CPU tensor goes to the plain version (:func:`plain`); a CUDA tensor goes to
the kernel, or the wrapper raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

plain = ref.rmsnorm  # the kernel's function in plain PyTorch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """Same ABI as ``ref.rmsnorm``: x (..., D), weight (D,) -> (..., D)."""
    if x.device.type == "cpu":
        return plain(x, weight, eps=eps)
    build.require_cuda("rmsnorm", x, weight)
    d = x.shape[-1]
    if x.dtype not in build.DTYPE_CODES or weight.dtype != x.dtype:
        raise build.KernelError(
            f"rmsnorm: x {x.dtype} / weight {weight.dtype}; needs one of "
            f"{list(build.DTYPE_CODES)} for both")
    if weight.shape != (d,):
        raise build.KernelError(f"rmsnorm: weight {tuple(weight.shape)} != ({d},)")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    err = build.library().xaas_rmsnorm(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d, eps,
        build.DTYPE_CODES[x.dtype], build.stream_of(x))
    build.check("rmsnorm", err)
    return out
