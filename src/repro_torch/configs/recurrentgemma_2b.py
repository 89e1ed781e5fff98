"""RecurrentGemma-2B — RG-LRU + local attention, 2:1 pattern, window 2048.
[arXiv:2402.19427; hf]"""
from repro_torch.models.config import ArchConfig, RecurrentConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,                        # MQA local attention
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    tie_embeddings=True,
    recurrent=RecurrentConfig(kind="rglru", lru_width=2560, d_conv=4,
                              attn_window=2048),
    sub_quadratic=True,                  # local attn + O(1) state
    optimizer="adamw",
    remat="save_dots",
)
