"""Token sampling: greedy / temperature / top-k, per slot, on the device.

``SamplingParams`` carries per-slot temperature and top-k as (B,) tensors so
the whole batch samples in one pass with no host branching per row. Greedy
rows take the argmax, exactly. Sampling rows draw Gumbel noise from an
explicit ``torch.Generator``; the JAX package draws from its own PRNG, so
sampled streams of the two agree in distribution only.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SamplingConfig", "SamplingParams", "sample_batched"]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 -> greedy
    top_k: int = 0  # 0 -> full distribution


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: torch.Tensor  # (B,) f32; <= 0 -> greedy for that row
    top_k: torch.Tensor  # (B,) int32; <= 0 -> full distribution

    @classmethod
    def from_configs(cls, cfgs: list[SamplingConfig],
                     device) -> "SamplingParams":
        return cls(
            torch.tensor([c.temperature for c in cfgs], dtype=torch.float32,
                         device=device),
            torch.tensor([c.top_k for c in cfgs], dtype=torch.int32,
                         device=device))


def sample_batched(logits: torch.Tensor, params: SamplingParams,
                   generator: torch.Generator | None) -> torch.Tensor:
    """logits (B, V) f32 -> int32 ids (B,).

    ``generator=None`` declares every row greedy (the caller knows it on the
    host), so no noise is drawn and nothing but the argmax runs. Otherwise
    rows with temperature > 0 sample from the temperature-scaled
    distribution restricted to their top-k (k clamped into [1, V]).
    """
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if generator is None:
        return greedy
    v = logits.shape[-1]
    scaled = logits / params.temperature.clamp_min(1e-6)[:, None]
    k = torch.where(params.top_k > 0, params.top_k, v).clamp(1, v)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = desc.gather(-1, (k - 1).long()[:, None])
    masked = scaled.masked_fill(scaled < kth, float("-inf"))
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    sampled = (masked + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(params.temperature > 0, sampled, greedy)
