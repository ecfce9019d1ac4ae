"""Model assembly, dense path: embedding, pre-norm blocks (global attention +
SwiGLU), final norm and LM head, with the serving entry points
(``prefill_chunk``, ``decode_step``, ``decode_and_sample``).

Layers are a Python list of per-layer parameter dicts (the JAX package
stacks them for ``lax.scan``; ``models/bridge.py`` unstacks). Serving state
is a list of per-layer ``{"k", "v"}`` caches, updated in place.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.profile import resolve_device
from repro_torch.models import attention, ffn, layers


def check_supported(cfg) -> None:
    """The port serves dense attention archs only so far."""
    bad = [s for s in cfg.layer_specs()
           if (s.mixer, s.ffn) != ("global_attn", "swiglu")]
    if bad or cfg.frontend or cfg.parallel_residual or cfg.embed_scale \
            or cfg.norm != "rmsnorm" or cfg.pos not in ("rope", "none"):
        raise NotImplementedError(
            f"{cfg.name}: only dense global-attention + SwiGLU archs with "
            "RMSNorm and RoPE are ported")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_model(cfg, *, seed: int = 0, device=None) -> dict[str, Any]:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, with
    the JAX package's distributions (truncated normal scaled by
    fan-in^-0.5, unit-scale embeddings, zero biases and norm weights)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = _dtype(cfg.param_dtype)
    params: dict[str, Any] = {
        "embed": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": layers.trunc_normal(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model**-0.5, dt)}
    params["final_norm"] = layers.init_norm(cfg.d_model, dtype=dt, device=dev)
    params["layers"] = [
        {"norm1": layers.init_norm(cfg.d_model, dtype=dt, device=dev),
         "mixer": attention.init(gen, cfg),
         "norm2": layers.init_norm(cfg.d_model, dtype=dt, device=dev),
         "ffn": ffn.init(gen, cfg)}
        for _ in range(cfg.num_layers)]
    return params


def init_states(cfg, batch: int, max_len: int, *, device=None,
                dtype: torch.dtype | None = None) -> list[dict]:
    """Per-layer serving state: zeroed (batch, max_len, Hkv, D) caches."""
    dev = resolve_device(device)
    dt = dtype or _dtype(cfg.activ_dtype)
    return [attention.init_state(cfg, batch, max_len, dt, dev)
            for _ in range(cfg.num_layers)]


def _block(p, cfg, x, mixer: Callable):
    h, _ = mixer(p["mixer"], layers.norm(p["norm1"], x))
    x = x + h
    return x + ffn.apply(p["ffn"], cfg, layers.norm(p["norm2"], x))


def lm_logits(params, cfg, x):
    """x: (..., D) -> f32 logits (..., V)."""
    x = layers.norm(params["final_norm"], x)
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x)
    return layers.linear(params["lm_head"], x).float()


def prefill_chunk(params, cfg, tokens, states, start, lengths):
    """Prefill a right-padded token chunk (B, Sc): each row's real tokens at
    the front, pads at the tail. ``lengths`` (B,) int32 counts each row's
    valid entries after the chunk. ``start`` (B,) int32 is the number of
    entries already in ``states``, or None for a fresh prefill (every row at
    0), which attends the chunk itself through the flash kernel.

    Returns (logits at each row's last real position (B, V) f32, states,
    lengths).
    """
    b, s = tokens.shape
    x = layers.embed(params["embed"], tokens).to(_dtype(cfg.activ_dtype))
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    positions = positions.expand(b, s) if start is None \
        else start[:, None] + positions
    for p, st in zip(params["layers"], states):
        x = _block(p, cfg, x, lambda pm, h, st=st: attention.prefill_chunk(
            pm, cfg, h, positions, st, start, lengths))
    offset = lengths if start is None else lengths - start
    x_last = x[torch.arange(b, device=x.device), (offset - 1).long()]
    return lm_logits(params, cfg, x_last), states, lengths


def decode_step(params, cfg, tokens, states, lengths):
    """One decode step. tokens (B,) int32 at position lengths - 1 (the cache
    entry written this step). Returns (logits (B, V) f32, states)."""
    x = layers.embed(params["embed"], tokens).to(_dtype(cfg.activ_dtype))
    for p, st in zip(params["layers"], states):
        x = _block(p, cfg, x, lambda pm, h, st=st: attention.decode(
            pm, cfg, h, st, lengths))
    return lm_logits(params, cfg, x), states


def decode_and_sample(params, cfg, tokens, states, lengths, sample_fn):
    """Decode + sample, the serving hot path: ``sample_fn(logits) -> ids``.
    Returns (new tokens (B,) int32, states, logits)."""
    logits, states = decode_step(params, cfg, tokens, states, lengths)
    return sample_fn(logits), states, logits
