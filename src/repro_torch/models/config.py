"""Architecture configuration schema.

A copy of ``repro.models.config`` (pure data).  One ``ArchConfig`` fully
describes a model in the zoo.  The 10 assigned
architectures (``configs/``) plus the paper's own ship-detection CNN
are all instances of this schema; ``reduced()`` derives the CPU-smoke-test
variant of any config.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, TYPE_CHECKING

if TYPE_CHECKING:
    from repro_torch.core.policy_map import PolicyMap


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    n_shared_experts: int = 0      # always-on shared experts (Kimi K2 style)
    n_dense_layers: int = 0        # leading layers that stay dense
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    """For SSM (rwkv6) and hybrid (recurrentgemma) families."""
    kind: str                      # "rwkv6" | "rglru"
    d_conv: int = 4                # griffin conv1d width
    lru_width: Optional[int] = None
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    attn_window: int = 2048
    head_dim: int = 64             # rwkv6 head size


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # "transformer" | "rwkv" | "hybrid" | "cnn"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default: d_model // n_heads
    qk_norm: bool = False
    swa_window: Optional[int] = None        # sliding-window attention
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    input_mode: str = "tokens"              # "tokens" | "embeddings" (audio/vlm stubs)
    sub_quadratic: bool = False             # True ⇒ long_500k cell is runnable
    # distribution hints
    fsdp_params: bool = False               # shard weights over the data axis too
    layout: str = "tp"                      # "tp" (model axis = tensor/expert
                                            # parallel) | "dp" (model axis is
                                            # extra data parallelism — right
                                            # call for small archs whose heads
                                            # don't divide the model axis)
    seq_shard: bool = False                 # sequence parallelism: shard the
                                            # seq dim of inter-block
                                            # activations over the model axis
                                            # (turns TP activation all-reduce
                                            # into reduce-scatter+all-gather,
                                            # halving collective bytes)
    param_dtype: str = "float32"            # "float32" | "bfloat16"
    compute_dtype: str = "bfloat16"         # activation/matmul dtype
    optimizer: str = "adamw"                # "adamw" | "adafactor"
    remat: str = "save_dots"                # "none" | "save_dots" | "full"
    grad_accum: int = 1                     # microbatches per step (activation
                                            # memory ÷ grad_accum; the lever
                                            # that makes 405B @ 4k seq fit
                                            # 16 GB HBM)
    quant: str = "none"                     # "none" | "w8a8_ffn" (the paper's
                                            # int8 technique on FFN/expert
                                            # weights+activations)
    quant_kv: bool = False                  # int8 KV cache with per-row
                                            # scales (serving: halves cache
                                            # reads vs bf16)
    attn_impl: str = "chunked"              # "chunked" (online softmax in
                                            # plain PyTorch) | "flash" (the
                                            # flash_attention_fwd_lse
                                            # kernel, full-sequence passes)
    policy_map: Optional["PolicyMap"] = None   # per-site dependability
                                            # assignment (core/policy_map.py)
                                            # for the quantized hot paths:
                                            # ``ffn.*`` matmul sites resolve
                                            # through it in-graph.  None ⇒
                                            # legacy unprotected path,
                                            # byte-identical dispatch.  Set
                                            # via models.api.with_policy_map
                                            # (validates rule backends)
    backend: Optional[str] = None           # execution backend for the
                                            # quantized primitives ("ref" |
                                            # "cuda" — the
                                            # core/backend.py registry); the
                                            # per-layer rung of the selection
                                            # ladder.  None (default) defers
                                            # to the global default, so
                                            # use_backend scopes still reach
                                            # models that never pinned one
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and memory napkin math)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "rwkv":
            attn = 4 * d * d + d * d // 2   # r,k,v,g,o + low-rank adapters (approx)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.moe is not None:
            m = self.moe
            dense_ffn = 3 * d * self.d_ff * m.n_dense_layers
            shared = 3 * d * m.d_expert * m.n_shared_experts * (L - m.n_dense_layers)
            routed = 3 * d * m.d_expert * m.n_experts * (L - m.n_dense_layers)
            router = d * m.n_experts * (L - m.n_dense_layers)
            ffn = dense_ffn + shared + routed + router
        else:
            ffn = 3 * d * self.d_ff * L
        return attn * L + ffn + embed + 2 * d * L + d

    def active_param_count(self) -> int:
        """Active-per-token params (MoE: top-k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        m = self.moe
        full = self.param_count()
        routed_all = 3 * d * m.d_expert * m.n_experts * (L - m.n_dense_layers)
        routed_active = 3 * d * m.d_expert * m.top_k * (L - m.n_dense_layers)
        return full - routed_all + routed_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def valid_cells(cfg: ArchConfig):
    """The (arch × shape) cells this config runs; long_500k needs sub-quadratic."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return [SHAPES[n] for n in names]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Small same-family variant for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_expert=32,
            n_dense_layers=min(cfg.moe.n_dense_layers, 1))
    if cfg.recurrent is not None:
        kw["recurrent"] = dataclasses.replace(
            cfg.recurrent, head_dim=8, attn_window=16,
            lru_width=64 if cfg.recurrent.lru_width else None)
    if cfg.swa_window is not None:
        kw["swa_window"] = 16
    return dataclasses.replace(cfg, **kw)
