"""Architecture registry: ``get(name)`` resolves here.

The counterpart of ``repro.configs.registry``, holding the configurations
the port runs: the dense, token-input transformers that fit one card.  The
reference's other names resolve to a ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3
from repro_torch.configs.smollm_135m import CONFIG as _smollm
from repro_torch.models.config import ArchConfig

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in (_smollm, _qwen3)}

_NOT_YET = {
    "kimi-k2-1t-a32b": "MoE and expert parallelism: ROADMAP.md queue 1, "
                       "item 17",
    "mixtral-8x7b": "MoE and expert parallelism: ROADMAP.md queue 1, item 17",
    "command-r-plus-104b": "a model sharded over several cards: ROADMAP.md "
                           "queue 1, item 17",
    "llama3-405b": "a model sharded over several cards: ROADMAP.md queue 1, "
                   "item 17",
    "rwkv6-1.6b": "the recurrent families: ROADMAP.md queue 1, item 16",
    "recurrentgemma-2b": "the recurrent families: ROADMAP.md queue 1, "
                         "item 16",
    "musicgen-large": "embedding-input models: ROADMAP.md queue 1, item 8",
    "llava-next-34b": "embedding-input models: ROADMAP.md queue 1, item 8",
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
