"""SmolLM-135M — llama-architecture small model. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="transformer",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    head_dim=64,
    tie_embeddings=True,
    optimizer="adamw",
    remat="save_dots",
)
