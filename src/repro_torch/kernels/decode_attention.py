"""Decode attention: wrapper around the Hopper kernel in
``csrc/decode_attention.cu``.

Replaces the JAX package's Pallas kernel
``kernels/decode_attention.py::decode_attention``. A CPU tensor goes to the
plain version (:func:`plain`); a CUDA tensor goes to the kernel, or the
wrapper raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, MAX_GROUP


def plain(q, k_cache, v_cache, *, lengths=None, window: int | None = None,
          scale: float | None = None,
          logit_softcap: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``ref.decode_attention``,
    except that a row with no visible position (length 0) gives zeros, as
    the kernel and the Pallas kernel do."""
    out = ref.decode_attention(q, k_cache, v_cache, lengths=lengths,
                               window=window, scale=scale,
                               logit_softcap=logit_softcap)
    b, s = k_cache.shape[:2]
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = kpos < lengths[:, None]
    if window is not None:
        mask &= kpos >= (lengths[:, None] - window)
    return out * mask.any(dim=1)[:, None, None].to(out.dtype)


def decode_attention(q, k_cache, v_cache, *, lengths=None,
                     window: int | None = None, scale: float | None = None,
                     logit_softcap: float | None = None) -> torch.Tensor:
    """Same ABI as ``ref.decode_attention``: q (B, Hq, D), caches
    (B, S, Hkv, D), lengths (B,) int32 -> (B, Hq, D)."""
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, lengths=lengths, window=window,
                     scale=scale, logit_softcap=logit_softcap)
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    build.require_cuda("decode_attention", q, k_cache, v_cache, lengths)
    if k_cache.shape != (b, s, hkv, d) or v_cache.shape != k_cache.shape:
        raise build.KernelError(
            f"decode_attention: q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} do not match")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise build.KernelError(
            f"decode_attention: lengths must be ({b},) int32, got "
            f"{tuple(lengths.shape)} {lengths.dtype}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) \
            or q.dtype not in build.DTYPE_CODES:
        raise build.KernelError(f"decode_attention: unsupported dtype {q.dtype}")
    if d not in HEAD_DIMS or hq % hkv or hq // hkv > MAX_GROUP:
        raise build.KernelError(
            f"decode_attention: head dim {d} (needs one of {HEAD_DIMS}) or "
            f"group {hq}/{hkv} (needs a divisor, at most {MAX_GROUP})")
    if window is not None and window < 1:
        raise build.KernelError(f"decode_attention: window {window} < 1")
    out = torch.empty_like(q)
    if out.numel() == 0 or s == 0:
        return out.zero_()
    err = build.library().xaas_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, s, hq, hkv, d, window or 0,
        logit_softcap or 0.0, scale if scale is not None else d**-0.5,
        build.DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check("decode_attention", err)
    return out
