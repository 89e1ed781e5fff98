"""MusicGen-large backbone — decoder-only over EnCodec tokens; the EnCodec
front end is a stub: the caller passes precomputed frame embeddings
(``embeds=`` (B, S, d) to ``forward``/``prefill``, ``embed=`` (B, d) to
``decode_step``), as ``data/pipeline.TokenStream`` draws them.
[arXiv:2306.05284; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="transformer",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,                       # MHA (kv == heads per assignment)
    d_ff=8192,
    vocab_size=2048,                     # EnCodec codebook
    head_dim=64,
    input_mode="embeddings",
    optimizer="adamw",
    remat="save_dots",
)
