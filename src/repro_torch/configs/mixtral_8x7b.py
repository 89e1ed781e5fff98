"""Mixtral 8x7B — 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="transformer",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    swa_window=4096,
    sub_quadratic=True,                 # SWA bounds the KV cache -> long_500k runs
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336),
    fsdp_params=True,
    param_dtype="bfloat16",
    optimizer="adamw",
    remat="save_dots",
)
