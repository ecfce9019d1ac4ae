"""Architecture config system (the port's own copy of ``repro.configs.base``).

An ArchConfig fully determines the model: layer pattern (mixers + FFNs),
dimensions and positional scheme. Layer layout
is ``prefix`` followed by ``pattern`` repeated ``scan_repeats`` times:

    num_layers == len(prefix) + len(pattern) * scan_repeats

The fields are those of the JAX package's config, less the family
sub-configs (MoE, MLA, RG-LRU, xLSTM) of families the port does not run yet:
it runs only the dense path (``global_attn`` + ``swiglu``), so a dense config
built there and one built here describe the same model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

MIXERS = ("global_attn", "local_attn", "mla", "rglru", "mlstm", "slstm")
FFNS = ("swiglu", "geglu", "gelu_mlp", "moe", "none")


@dataclass(frozen=True)
class LayerSpec:
    mixer: str
    ffn: str

    def __post_init__(self):
        if self.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in FFNS:
            raise ValueError(f"unknown ffn {self.ffn!r}")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    dense_d_ff: int = 0  # ff dim of dense layers in MoE archs (0 -> d_ff)
    prefix: tuple[LayerSpec, ...] = ()
    pattern: tuple[LayerSpec, ...] = (LayerSpec("global_attn", "swiglu"),)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    parallel_residual: bool = False
    pos: str = "rope"  # rope | sinusoidal | none
    rope_theta: float = 10000.0
    local_window: int = 2048
    logit_softcap: float | None = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    embed_scale: bool = False
    frontend: str | None = None
    num_image_tokens: int = 2928
    num_codebooks: int = 1
    subquadratic: bool = False
    param_dtype: str = "bfloat16"
    activ_dtype: str = "bfloat16"

    def __post_init__(self):
        scanned = self.num_layers - len(self.prefix)
        if scanned < 0 or not self.pattern or scanned % len(self.pattern):
            raise ValueError(
                f"{self.name}: {scanned} scanned layers not divisible by "
                f"pattern period {len(self.pattern)}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: num_heads % num_kv_heads != 0")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def scan_repeats(self) -> int:
        return (self.num_layers - len(self.prefix)) // len(self.pattern)

    def layer_specs(self) -> list[LayerSpec]:
        return list(self.prefix) + list(self.pattern) * self.scan_repeats


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: keeps every structural
    feature at toy width/depth (the same reduction as the JAX package's)."""
    period = len(cfg.pattern)
    n_prefix = len(cfg.prefix)
    layers = n_prefix + period * min(2, cfg.scan_repeats)
    hd = 16
    kv = min(cfg.num_kv_heads, 2)
    heads = kv * min(4, cfg.num_heads // cfg.num_kv_heads)
    d = 64
    changes: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=hd,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        local_window=16,
        num_image_tokens=8,
        param_dtype="float32",
        activ_dtype="float32",
    )
    if cfg.dense_d_ff:
        changes["dense_d_ff"] = 128
    return dataclasses.replace(cfg, **changes)
