"""Parameters and train states of the reference package, as numpy
arrays, into the port's.

The two packages draw different random numbers from the same seed, so a
comparison between them starts from one set of parameters: the reference's,
fetched to the host (``jax.device_get``), converted here.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.qconv2d.ops import QConvParams

_QPARAMS = ("in_scale", "in_zp", "out_scale", "out_zp")


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: carry the bits across
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def shipdet_params_from_numpy(layers: List[Dict[str, Any]],
                              device="cuda") -> List[Dict[str, Any]]:
    """Per layer: ``qconv`` (anything with ``w_q``, ``w_scale``, ``colsum``
    and ``bias_f`` attributes, e.g. the reference's ``QConvParams`` of numpy
    arrays) and the four activation qparams, as the port's tensors."""
    dev = resolve_device(device)
    out = []
    for layer in layers:
        q = layer["qconv"]
        out.append({
            "qconv": QConvParams(*(_tensor(getattr(q, f), dev)
                                   for f in QConvParams._fields)),
            **{k: _tensor(layer[k], dev) for k in _QPARAMS},
        })
    return out


def transformer_params_from_numpy(tree: Dict[str, Any],
                                  device="cuda") -> Dict[str, Any]:
    """The reference's transformer parameter dict (numpy leaves, nested
    dicts, int8 ``*_q`` and f32 ``*_s`` leaves included) as the port's:
    the same keys, shapes and dtypes."""
    dev = resolve_device(device)

    def conv(v):
        return {k: conv(x) for k, x in v.items()} if isinstance(v, dict) \
            else _tensor(v, dev)
    return conv(tree)


def rwkv6_params_from_numpy(tree: Dict[str, Any],
                            device="cuda") -> Dict[str, Any]:
    """The reference's ``models.rwkv6`` parameter dict (``embed``,
    ``final_norm``, ``lm_head`` and the stacked ``blocks``) as the port's
    ``models/rwkv6.py`` takes it: the same keys, shapes and dtypes."""
    return _params_tree(tree, ("embed", "final_norm", "lm_head", "blocks"),
                        device)


def griffin_params_from_numpy(tree: Dict[str, Any],
                              device="cuda") -> Dict[str, Any]:
    """The reference's ``models.griffin`` parameter dict (``rec_blocks``,
    ``attn_blocks``, ``tail_rec`` where the depth leaves recurrent layers
    over, ``lm_head`` where the embedding is not tied) as the port's
    ``models/griffin.py`` takes it."""
    return _params_tree(tree, ("embed", "final_norm", "rec_blocks",
                               "attn_blocks", "tail_rec", "lm_head"), device)


def _params_tree(tree, known, device):
    unknown = sorted(set(tree) - set(known))
    if unknown:
        raise KeyError(f"unexpected parameter groups {unknown}")
    return transformer_params_from_numpy(tree, device)


def train_state_from_numpy(state, device="cuda"):
    """The reference's ``TrainState`` (params, optimizer state and step,
    numpy leaves in nested dicts) as the port's ``train.steps.TrainState``:
    the same trees, the step a () int32 tensor."""
    from repro_torch.train.steps import TrainState
    dev = resolve_device(device)
    params, opt_state, step = state
    return TrainState(transformer_params_from_numpy(params, dev),
                      transformer_params_from_numpy(opt_state, dev),
                      torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                   device=dev))
