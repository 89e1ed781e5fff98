"""Family-dispatching model API.

The counterpart of ``repro.models.api``: launchers, the serving engine and
tests talk to models through these functions, and the config's ``family``
picks the implementation: ``transformer``, ``rwkv`` (models/rwkv6.py) or
``hybrid`` (models/griffin.py).

``cfg.backend`` is the per-layer rung of the backend selection
(core/backend.py): ``with_backend(cfg, "ref")`` swaps the W8A8 FFN from the
hand kernels to the plain oracle with no model code changed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models import common, griffin, rwkv6, transformer
from repro_torch.models.config import ArchConfig


def with_backend(cfg: ArchConfig, backend: Optional[str]) -> ArchConfig:
    """The config with its quantized-primitive backend pinned (validated
    against the registry); None leaves the config untouched."""
    if backend is None or backend == cfg.backend:
        return cfg
    from repro_torch.core import backend as backend_mod
    backend_mod.get_backend(backend)
    return dataclasses.replace(cfg, backend=backend)


def with_policy_map(cfg: ArchConfig, policy_map) -> ArchConfig:
    """The config with a per-site dependability policy map baked in: the
    quantized FFN matmuls resolve ``ffn.<name>`` through it.  Accepts a
    PolicyMap, a JSON doc/text/path, or None (config untouched); every
    backend the map names is validated up front."""
    from repro_torch.core.policy_map import as_policy_map
    pm = as_policy_map(policy_map)
    if pm is None or pm == cfg.policy_map:
        return cfg
    from repro_torch.core import backend as backend_mod
    for name in pm.backends():
        backend_mod.get_backend(name)
    return dataclasses.replace(cfg, policy_map=pm)


def _mod(cfg: ArchConfig):
    if cfg.family == "transformer":
        return transformer
    if cfg.family == "rwkv":
        return rwkv6
    if cfg.family == "hybrid":
        return griffin
    raise ValueError(f"unknown family {cfg.family!r} (cnn goes through "
                     f"models/shipdet.py)")


def init_params(cfg, gen, *, device="cuda"):
    return _mod(cfg).init_params(cfg, gen, device=device)


def forward(cfg, params, tokens, ctx=None, embeds=None):
    return _mod(cfg).forward(cfg, params, tokens, ctx, embeds=embeds)


def loss_fn(cfg, params, batch, ctx=None):
    return _mod(cfg).loss_fn(cfg, params, batch, ctx)


def init_cache(cfg, B, max_len, dtype=None, *, device="cuda"):
    return _mod(cfg).init_cache(cfg, B, max_len, dtype, device=device)


def decode_step(cfg, params, token, cache, ctx=None, embed=None):
    return _mod(cfg).decode_step(cfg, params, token, cache, ctx, embed=embed)


def prefill(cfg, params, tokens, max_len, ctx=None, embeds=None):
    return _mod(cfg).prefill(cfg, params, tokens, max_len, ctx,
                             embeds=embeds)


def cache_write_slot(batch_cache, one_cache, slot, n):
    """Splice a single-request prefill cache into row ``slot`` of a batch
    cache, in place, for any family's cache (models/common.py)."""
    return common.cache_write_slot(batch_cache, one_cache, slot, n)
