"""Flash attention (prefill): wrapper around the Hopper kernel in
``csrc/flash_attention.cu``.

Replaces the JAX package's Pallas kernel
``kernels/flash_attention.py::flash_attention``. A CPU tensor goes to the
plain version (:func:`plain`); a CUDA tensor goes to the kernel, or the
wrapper raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernel is instantiated for
MAX_GROUP = 16  # query heads per kv head: one warp each


def plain(q, k, v, *, causal: bool = True, window: int | None = None,
          scale: float | None = None,
          logit_softcap: float | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``ref.attention``, except that
    a query row with no visible key gives zeros (the kernel's convention, and
    the Pallas kernel's), not the uniform average that the reference's
    -1e30 fill gives. Such rows exist only when causal and Sq > Skv."""
    out = ref.attention(q, k, v, causal=causal, window=window, scale=scale,
                        logit_softcap=logit_softcap)
    sq, skv = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return out * mask.any(dim=1)[None, :, None, None].to(out.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    logit_softcap: float | None = None) -> torch.Tensor:
    """Same ABI as ``ref.attention``: q (B, Sq, Hq, D), k, v (B, Skv, Hkv, D)
    -> (B, Sq, Hq, D)."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, scale=scale,
                     logit_softcap=logit_softcap)
    build.require_cuda("flash_attention", q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, skv, hkv, d) or v.shape != k.shape:
        raise build.KernelError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in build.DTYPE_CODES:
        raise build.KernelError(f"flash_attention: unsupported dtype {q.dtype}")
    if d not in HEAD_DIMS or hq % hkv or hq // hkv > MAX_GROUP:
        raise build.KernelError(
            f"flash_attention: head dim {d} (needs one of {HEAD_DIMS}) or "
            f"group {hq}/{hkv} (needs a divisor, at most {MAX_GROUP})")
    if window is not None and window < 1:
        raise build.KernelError(f"flash_attention: window {window} < 1")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = build.library().xaas_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, skv, hq, hkv, d, int(causal), window or 0,
        logit_softcap or 0.0, scale if scale is not None else d**-0.5,
        build.DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check("flash_attention", err)
    return out
