"""Qwen3-0.6B — GQA with qk-norm. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="transformer",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=64,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    optimizer="adamw",
    remat="save_dots",
)
