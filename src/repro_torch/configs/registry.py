"""Architecture registry: ``get(name)`` resolves here.

The counterpart of ``repro.configs.registry``, holding the configurations
the port runs: the dense transformers that fit one card, token-input and
embedding-input (``musicgen-large``, ``llava-next-34b``: the caller's
``embeds`` stand in for their stub front ends), and the recurrent
families (``rwkv6-1.6b``, ``recurrentgemma-2b``).  The
reference's other names resolve to a ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.smollm_135m import CONFIG as _smollm
from repro_torch.models.config import ArchConfig

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (_smollm, _qwen3, _rwkv6, _musicgen, _llava,
                        _rgemma)}

_NOT_YET = {
    "kimi-k2-1t-a32b": "MoE and expert parallelism: ROADMAP.md queue 1, "
                       "item 17",
    "mixtral-8x7b": "MoE and expert parallelism: ROADMAP.md queue 1, item 17",
    "command-r-plus-104b": "a model sharded over several cards: ROADMAP.md "
                           "queue 1, item 17",
    "llama3-405b": "a model sharded over several cards: ROADMAP.md queue 1, "
                   "item 17",
}


def get(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in _NOT_YET:
        raise NotImplementedError(
            f"arch {name!r} is not in the port yet: {_NOT_YET[name]}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def names():
    return sorted(ARCHS)
