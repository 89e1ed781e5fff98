"""Architecture registry: ``get(name)`` resolves here.

The counterpart of ``repro.configs.registry``, holding the configurations
the port runs, every name of the reference's: the dense transformers,
token-input (``command-r-plus-104b`` and ``llama3-405b`` among them: their
``fsdp_params`` shards weights over dp under a ``ShardCtx``) and
embedding-input (``musicgen-large``, ``llava-next-34b``: the caller's
``embeds`` stand in for their stub front ends), the mixture-of-experts
transformers (``mixtral-8x7b``, ``kimi-k2-1t-a32b``: the meshless MoE
path, and the meshed one under a ``ShardCtx``), and the recurrent families
(``rwkv6-1.6b``, ``recurrentgemma-2b``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.command_r_plus_104b import CONFIG as _cmdr
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.llama3_405b import CONFIG as _llama3
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.smollm_135m import CONFIG as _smollm
from repro_torch.models.config import ArchConfig, valid_cells

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (_smollm, _qwen3, _cmdr, _llama3, _rwkv6, _musicgen,
                        _llava, _rgemma, _mixtral, _kimi)}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Every runnable (arch, shape) pair: 33 cells (long_500k only for the
    sub-quadratic families)."""
    return [(cfg, shape) for cfg in ARCHS.values()
            for shape in valid_cells(cfg)]


def names():
    return sorted(ARCHS)
