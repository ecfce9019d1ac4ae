"""Weight bridge: the JAX package's parameter tree, as numpy arrays, to the
port's parameters.

The JAX tree holds ``prefix`` blocks unrolled and the repeated ``pattern``
blocks stacked along a leading layer axis under ``scan`` (for ``lax.scan``);
the port keeps one dict per layer in ``layers``. Everything else maps by
name. Tests feed ``jax.device_get(init_model(...))`` through here so both
implementations run the same weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.profile import resolve_device


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, dtype=np.float32))
    return t.to(device=device, dtype=dtype)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_numpy(tree: dict, cfg, *, device=None) -> dict[str, Any]:
    """``tree``: the JAX parameter pytree with numpy leaves. Leaves are cast
    to ``cfg.param_dtype`` on ``device`` (the card unless asked otherwise)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    blocks = list(tree["prefix"])
    for r in range(cfg.scan_repeats):
        blocks += [_layer(stacked, r) for stacked in tree["scan"]]
    out = {k: _to_torch(v, dev, dt) for k, v in tree.items()
           if k not in ("prefix", "scan")}
    out["layers"] = [_to_torch(b, dev, dt) for b in blocks]
    return out
