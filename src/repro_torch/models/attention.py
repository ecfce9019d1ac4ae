"""Global attention mixer: GQA, QKV bias, RoPE, and a contiguous per-row KV
cache (B, max_len, Hkv, D).

The cache is updated in place (the JAX package returns a new one); each
function also returns the state so callers read the same way in both.
"""
from __future__ import annotations

import torch

from repro_torch.core import hooks
from repro_torch.models import layers


def init(gen, cfg):
    hd = cfg.resolved_head_dim
    dt = getattr(torch, cfg.param_dtype)
    return {
        "wq": layers.init_linear(gen, cfg.d_model, cfg.num_heads * hd,
                                 bias=cfg.qkv_bias, dtype=dt),
        "wk": layers.init_linear(gen, cfg.d_model, cfg.num_kv_heads * hd,
                                 bias=cfg.qkv_bias, dtype=dt),
        "wv": layers.init_linear(gen, cfg.d_model, cfg.num_kv_heads * hd,
                                 bias=cfg.qkv_bias, dtype=dt),
        "wo": layers.init_linear(gen, cfg.num_heads * hd, cfg.d_model,
                                 dtype=dt),
    }


def init_state(cfg, batch: int, max_len: int, dtype, device=None):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = layers.linear(p["wq"], x).reshape(b, s, cfg.num_heads, hd)
    k = layers.linear(p["wk"], x).reshape(b, s, cfg.num_kv_heads, hd)
    v = layers.linear(p["wv"], x).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.pos == "rope":
        q = layers.apply_rope(q, positions, theta=cfg.rope_theta)
        k = layers.apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def prefill_chunk(p, cfg, x, positions, state, start, lengths, *,
                  window: int | None = None):
    """Prefill a right-padded chunk x (B, Sc, D) (pre-normed) at absolute
    ``positions`` (B, Sc); ``lengths`` (B,) counts the valid entries after
    the chunk. Pad rows (chunk index >= lengths - start) are not written to
    the cache and give outputs the caller ignores.

    ``start=None`` is the fresh-prefill route: every row starts at 0 and the
    cache holds nothing before the chunk, so the queries attend the chunk's
    own K/V causally through the ``attention`` API (the flash kernel), which
    at every real position equals attending the cache. With a ``start``
    tensor the queries attend the whole cache through ``chunk_attention``.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    kc, vc = state["k"], state["v"]
    if start is None:
        if s > kc.shape[1]:
            raise ValueError(f"chunk {s} > cache length {kc.shape[1]}")
        valid = (torch.arange(s, device=x.device)[None, :]
                 < lengths[:, None])[..., None, None]
        # pads keep what the cache held: the write drops them
        kc[:, :s] = torch.where(valid, k.to(kc.dtype), kc[:, :s])
        vc[:, :s] = torch.where(valid, v.to(vc.dtype), vc[:, :s])
        o = hooks.call("attention", q, k, v, causal=True, window=window,
                       logit_softcap=cfg.logit_softcap)
    else:
        valid = (torch.arange(s, device=x.device)[None, :]
                 < (lengths - start)[:, None])
        rows, cols = valid.nonzero(as_tuple=True)
        kc[rows, positions[rows, cols]] = k[rows, cols].to(kc.dtype)
        vc[rows, positions[rows, cols]] = v[rows, cols].to(vc.dtype)
        o = hooks.call("chunk_attention", q, kc, vc, positions=positions,
                       window=window, logit_softcap=cfg.logit_softcap)
    y = layers.linear(p["wo"], o.reshape(b, s, -1))
    return y, state


def decode(p, cfg, x, state, lengths, *, window: int | None = None):
    """Single-token decode. x: (B, D) pre-normed; ``lengths`` (B,) counts the
    valid entries *including* the current token, written at lengths - 1."""
    b, _ = x.shape
    hd = cfg.resolved_head_dim
    pos = (lengths - 1).to(torch.int32)
    q = layers.linear(p["wq"], x).reshape(b, 1, cfg.num_heads, hd)
    k = layers.linear(p["wk"], x).reshape(b, 1, cfg.num_kv_heads, hd)
    v = layers.linear(p["wv"], x).reshape(b, 1, cfg.num_kv_heads, hd)
    if cfg.pos == "rope":
        q = layers.apply_rope(q, pos[:, None], theta=cfg.rope_theta)
        k = layers.apply_rope(k, pos[:, None], theta=cfg.rope_theta)
    # an empty row (length 0) writes at -1, i.e. the cache's last entry, as
    # the JAX package's scatter does; its output is never read
    bidx = torch.arange(b, device=x.device)
    state["k"][bidx, pos.long()] = k[:, 0].to(state["k"].dtype)
    state["v"][bidx, pos.long()] = v[:, 0].to(state["v"].dtype)
    o = hooks.call("decode_attention", q[:, 0], state["k"], state["v"],
                   lengths=lengths, window=window,
                   logit_softcap=cfg.logit_softcap)
    y = layers.linear(p["wo"], o.reshape(b, -1))
    return y, state
