"""Plain PyTorch reference for every accelerated API of the port.

These are the ``torch-ref`` tier each hook binds when no kernel tier does,
and the oracle the kernels' tests compare against. They follow the JAX
package's ``kernels/ref.py`` line for line: every numeric that matters
(softmax, norms) runs in float32 whatever the input type and is cast back,
so the reference and the kernel tiers share one contract: "inputs of type X
give outputs of type X, accumulation in f32".
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with a zero-centred weight:
    ``x * rsqrt(mean(x^2) + eps) * (1 + w)``. x: (..., D), weight: (D,)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., K), w: (K, N) -> (..., N) in x's type; f32 accumulation
    (cuBLAS accumulates bf16 products in f32)."""
    return torch.matmul(x, w.to(x.dtype))


def _gqa_expand(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """(B,S,Hkv,D) -> (B,S,Hq,D) by repeating each kv head Hq/Hkv times."""
    hkv = k.shape[2]
    if hkv == n_q_heads:
        return k
    return k.repeat_interleave(n_q_heads // hkv, dim=2)


def _softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    return logits if cap is None else cap * torch.tanh(logits / cap)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None,
              logit_softcap: float | None = None) -> torch.Tensor:
    """Multi-head attention with GQA by head broadcast.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D). Query i sits at key position
    i + (Skv - Sq) (suffix alignment). ``window`` keeps the last ``window``
    positions. Returns (B, Sq, Hq, D) in q's type.
    """
    sq, hq, dh = q.shape[1], q.shape[2], q.shape[3]
    skv = k.shape[1]
    scale = scale if scale is not None else dh**-0.5
    kx = _gqa_expand(k, hq).float()
    vx = _gqa_expand(v, hq).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * scale
    logits = _softcap(logits, logit_softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask[None, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vx)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, lengths=None,
                     window: int | None = None, scale: float | None = None,
                     logit_softcap: float | None = None) -> torch.Tensor:
    """One query token against a KV cache.

    q: (B, Hq, D); caches: (B, S, Hkv, D); lengths: (B,) int32 valid entries
    (the current token is the last valid one). Positions >= length are
    masked; ``window`` keeps the trailing ``window`` valid positions.
    Returns (B, Hq, D).
    """
    b, hq, dh = q.shape
    s = k_cache.shape[1]
    scale = scale if scale is not None else dh**-0.5
    kx = _gqa_expand(k_cache, hq).float()
    vx = _gqa_expand(v_cache, hq).float()
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), kx) * scale
    logits = _softcap(logits, logit_softcap)
    kpos = torch.arange(s, device=q.device)[None, :]
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    mask = kpos < lengths[:, None]
    if window is not None:
        mask &= kpos >= (lengths[:, None] - window)
    logits = logits.masked_fill(~mask[:, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs, vx)
    return out.to(q.dtype)


def chunk_attention(q, k_cache, v_cache, *, positions,
                    window: int | None = None, scale: float | None = None,
                    logit_softcap: float | None = None) -> torch.Tensor:
    """A chunk of queries at absolute per-row ``positions`` (B, Sq) against
    a whole KV cache (B, L, Hkv, D): cache slot j is visible to query i iff
    j <= positions[b, i] (and inside the window). Returns (B, Sq, Hq, D)."""
    hq, dh = q.shape[2], q.shape[3]
    lkv = k_cache.shape[1]
    scale = scale if scale is not None else dh**-0.5
    kx = _gqa_expand(k_cache, hq).float()
    vx = _gqa_expand(v_cache, hq).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * scale
    logits = _softcap(logits, logit_softcap)
    kpos = torch.arange(lkv, device=q.device)[None, None, :]
    qpos = positions[:, :, None]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask[:, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vx)
    return out.to(q.dtype)
