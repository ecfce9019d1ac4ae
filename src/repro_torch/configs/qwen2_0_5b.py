"""qwen2-0.5b [dense] — GQA, QKV bias, tied embeddings.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936  [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    pattern=(LayerSpec("global_attn", "swiglu"),),
    qkv_bias=True,
    tie_embeddings=True,
    pos="rope",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
)
