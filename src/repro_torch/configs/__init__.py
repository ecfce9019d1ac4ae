"""Architecture config registry of the port: the archs it serves, by --arch id."""
from __future__ import annotations

from repro_torch.configs import qwen2_0_5b
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    LayerSpec,
    smoke_variant,
)

_ARCHS: dict[str, ArchConfig] = {
    "qwen2-0.5b": qwen2_0_5b.CONFIG,
}

ARCH_IDS = tuple(_ARCHS)


def get_config(arch_id: str) -> ArchConfig:
    """The config for ``arch_id``; a ``-smoke`` suffix gives its reduced
    same-family variant."""
    if arch_id.endswith("-smoke"):
        return smoke_variant(get_config(arch_id[: -len("-smoke")]))
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[arch_id]
