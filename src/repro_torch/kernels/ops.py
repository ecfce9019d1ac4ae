"""Accelerated-API registration of the port.

Every API gets its ``torch-ref`` tier (``kernels/ref.py``, the reference).
The three APIs of the serving path that the JAX package ran through Pallas
TPU kernels also get a ``cuda-sm90`` tier: the hand-written Hopper kernels,
bound on a profile that advertises ``cuda-sm90``.

Each ``cuda-sm90`` tier carries a probe that builds the kernels and runs a
tiny case on the card against the plain version. On a GPU profile a failed
probe raises at bind time (``core/hooks.py``).

``matmul`` and ``chunk_attention`` have no Pallas kernel in the JAX package
and stay plain PyTorch (``torch.matmul`` for products).
"""
from __future__ import annotations

import torch

from repro_torch.core import hooks
from repro_torch.core.profile import SystemProfile, profile_for
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms

HOPPER = "cuda-sm90"


def _supports_hopper(profile: SystemProfile) -> bool:
    return profile.supports(HOPPER)


def _probe_device(profile: SystemProfile) -> torch.device:
    if profile.device != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"profile {profile.name} has no CUDA device here")
    return torch.device("cuda")


def _agree(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not err <= 2e-5:
        raise RuntimeError(f"kernel disagrees with its plain version: {err}")


def _probe_rmsnorm(profile: SystemProfile) -> None:
    dev = _probe_device(profile)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(3, 64, generator=g, device=dev)
    w = torch.randn(64, generator=g, device=dev) * 0.1
    _agree(_rms.rmsnorm(x, w), _rms.plain(x, w))


def _probe_flash(profile: SystemProfile) -> None:
    dev = _probe_device(profile)
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, 9, 4, 16, generator=g, device=dev)
    k, v = torch.randn(2, 1, 9, 2, 16, generator=g, device=dev)
    _agree(_fa.flash_attention(q, k, v), _fa.plain(q, k, v))


def _probe_decode(profile: SystemProfile) -> None:
    dev = _probe_device(profile)
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 4, 16, generator=g, device=dev)
    k, v = torch.randn(2, 2, 40, 2, 16, generator=g, device=dev)
    lengths = torch.tensor([1, 37], dtype=torch.int32, device=dev)
    _agree(_dec.decode_attention(q, k, v, lengths=lengths),
           _dec.plain(q, k, v, lengths=lengths))


def _register() -> None:
    reg = hooks.register_api
    reg("rmsnorm",
        "rmsnorm(x(...,D), weight(D,), *, eps) -> (...,D); f32 accumulation",
        ref.rmsnorm)
    reg("matmul", "matmul(x(...,K), w(K,N)) -> (...,N); f32 acc", ref.matmul)
    reg("attention",
        "attention(q(B,Sq,Hq,D), k(B,Skv,Hkv,D), v, *, causal, window, scale,"
        " logit_softcap) -> (B,Sq,Hq,D)", ref.attention)
    reg("decode_attention",
        "decode_attention(q(B,Hq,D), k_cache(B,S,Hkv,D), v_cache, *,"
        " lengths(B,), window, scale, logit_softcap) -> (B,Hq,D)",
        ref.decode_attention)
    reg("chunk_attention",
        "chunk_attention(q(B,Sq,Hq,D), k_cache(B,L,Hkv,D), v_cache, *,"
        " positions(B,Sq), window, scale, logit_softcap) -> (B,Sq,Hq,D)",
        ref.chunk_attention)
    impl = hooks.register_impl
    impl("rmsnorm", HOPPER, _rms.rmsnorm, supports=_supports_hopper,
         probe=_probe_rmsnorm)
    impl("attention", HOPPER, _fa.flash_attention, supports=_supports_hopper,
         probe=_probe_flash)
    impl("decode_attention", HOPPER, _dec.decode_attention,
         supports=_supports_hopper, probe=_probe_decode)


_register()


def bind_for(device: torch.device) -> hooks.Binding:
    """The probed binding for ``device``: the Hopper tiers on an H100, the
    reference on the CPU."""
    return hooks.bind(profile_for(device), probe=True)
