"""Target-system profiles and device resolution.

A ``SystemProfile`` names a deployment target and the kernel tiers it can
bind (``capabilities``). Peaks are published numbers of the part, used to
compute roofline bounds; they are never measurements.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SystemProfile:
    name: str
    device: str  # torch device type the profile runs on: "cuda" | "cpu"
    capabilities: frozenset[str] = frozenset()
    # NVIDIA H100 SXM data sheet (dense, no sparsity, at the 700 W limit)
    hbm_bytes_per_s: float | None = None
    bf16_flops: float | None = None
    f32_flops: float | None = None  # outside the tensor cores

    def supports(self, capability: str) -> bool:
        return capability in self.capabilities


H100_SM90 = SystemProfile(
    name="h100-sm90", device="cuda",
    capabilities=frozenset({"cuda-sm90"}),
    hbm_bytes_per_s=3.35e12, bf16_flops=989e12, f32_flops=67e12)

PORTABLE_CPU = SystemProfile(name="cpu", device="cpu")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card. Raises when CUDA is asked for and absent:
    entry points never carry on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def profile_for(device: torch.device) -> SystemProfile:
    """The profile of ``device``: the Hopper profile for a capability-(9, 0)
    card, the CPU profile for the CPU; any other card has no kernel tier
    and raises."""
    if device.type == "cpu":
        return PORTABLE_CPU
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has capability {cap}; "
            "the port's kernels are built for sm_90a (Hopper) only")
    return H100_SM90
