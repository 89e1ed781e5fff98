"""Command R+ 104B — dense GQA, no biases, large vocab.
[hf:CohereForAI/c4ai-command-r-v01 family; unverified]

A copy of ``repro/configs/command_r_plus_104b.py``.  ``fsdp_params``
shards each weight's non-TP dim over the dp axes under a ``ShardCtx``
(``parallel/sharding.py``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="transformer",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
    use_bias=False,
    fsdp_params=True,
    param_dtype="bfloat16",
    optimizer="adamw",
    remat="full",
)
