"""SwiGLU feed-forward block (llama lineage)."""
from __future__ import annotations

import torch

from repro_torch.models import layers


def init(gen, cfg):
    dt = getattr(torch, cfg.param_dtype)
    dff = cfg.dense_d_ff or cfg.d_ff
    return {
        "w_gate": layers.init_linear(gen, cfg.d_model, dff, dtype=dt),
        "w_up": layers.init_linear(gen, cfg.d_model, dff, dtype=dt),
        "w_down": layers.init_linear(gen, dff, cfg.d_model, dtype=dt),
    }


def apply(p, cfg, x):
    """x: (..., D) pre-normed -> (..., D); the gate runs in f32."""
    g = layers.linear(p["w_gate"], x)
    u = layers.linear(p["w_up"], x)
    h = (torch.nn.functional.silu(g.float()) * u.float()).to(x.dtype)
    return layers.linear(p["w_down"], h)
