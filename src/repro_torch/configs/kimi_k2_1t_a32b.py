"""Kimi K2 — trillion-parameter MoE (384 routed experts, top-8, 1 shared,
first layer dense).  [arXiv:2501.kimi2; paper-table]"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="transformer",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=112,                       # d_model / n_heads
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048,
                  n_shared_experts=1, n_dense_layers=1),
    fsdp_params=True,
    param_dtype="bfloat16",
    optimizer="adafactor",              # Adam states would not fit 512×16 GB
    remat="full",
    notes="1T total / ~32B active; EP over model axis (24 experts/shard), "
          "expert d_expert FSDP over dp; full attention -> long_500k skipped",
)
