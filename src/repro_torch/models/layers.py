"""Shared model primitives: inits, linear (through the matmul hook), norm,
RoPE, embedding and the tied LM head.

Parameters are plain dicts of tensors, as in the JAX package, with weights
laid out (in_features, out_features) so the weight bridge copies them as
they are.
"""
from __future__ import annotations

import torch

from repro_torch.core import hooks
from repro_torch.kernels import ops  # noqa: F401  (registers the APIs)


def trunc_normal(gen: torch.Generator, shape, scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``scale``, drawn in f32 on the
    generator's device and cast (the JAX package's ``trunc_normal``)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def init_linear(gen, d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.float32):
    p = {"w": trunc_normal(gen, (d_in, d_out), d_in**-0.5, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) -> (..., d_out) through the matmul hook."""
    y = hooks.call("matmul", x, p["w"])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def init_norm(d: int, *, dtype=torch.float32, device=None):
    """RMSNorm weight, zero-centred: the norm scales by ``1 + w``."""
    return {"w": torch.zeros((d,), dtype=dtype, device=device)}


def norm(p, x: torch.Tensor) -> torch.Tensor:
    return hooks.call("rmsnorm", x, p["w"])


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """Half-split (not interleaved) rotary embedding. x: (B, S, H, D) with D
    even; positions: (B, S) or (S,) integer; angles in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_embedding(gen, vocab: int, d: int, dtype=torch.float32):
    return {"w": trunc_normal(gen, (vocab, d), 1.0, dtype)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["w"][tokens]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: (..., D) @ (V, D)^T -> (..., V) f32 logits, accumulated
    in f32 and never rounded to x's type."""
    w = p["w"]
    if x.dtype == torch.float32:
        return torch.matmul(x, w.t().float())
    lead = x.shape[:-1]
    y = torch.mm(x.reshape(-1, x.shape[-1]), w.t().to(x.dtype),
                 out_dtype=torch.float32)
    return y.reshape(*lead, w.shape[0])
