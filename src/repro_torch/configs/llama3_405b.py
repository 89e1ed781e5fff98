"""Llama 3 405B — dense GQA, 128k vocab. [arXiv:2407.21783; unverified]

A copy of ``repro/configs/llama3_405b.py``.  ``fsdp_params`` shards each
weight's non-TP dim over the dp axes under a ``ShardCtx``
(``parallel/sharding.py``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="transformer",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    fsdp_params=True,
    param_dtype="bfloat16",
    optimizer="adafactor",
    remat="full",
)
