"""LLaVA-NeXT 34B backbone — the anyres patch front end is a stub: the
caller passes precomputed patch embeddings (``embeds=`` (B, S, d) to
``forward``/``prefill``, ``embed=`` (B, d) to ``decode_step``), as
``data/pipeline.TokenStream`` draws them. [hf:llava-hf family; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="transformer",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    input_mode="embeddings",
    fsdp_params=True,
    param_dtype="bfloat16",
    optimizer="adamw",
    remat="full",
)
