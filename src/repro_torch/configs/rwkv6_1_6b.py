"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.models.config import ArchConfig, RecurrentConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    n_layers=24,
    d_model=2048,
    n_heads=32,                          # d_model / head_dim
    n_kv_heads=1,
    d_ff=7168,
    vocab_size=65536,
    recurrent=RecurrentConfig(kind="rwkv6", head_dim=64),
    sub_quadratic=True,                  # O(1) state -> long_500k runs
    optimizer="adamw",
    remat="save_dots",
)
