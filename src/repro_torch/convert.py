"""Parameters of the reference package, as numpy arrays, into the port's.

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
    return torch.from_numpy(np.array(a, copy=True)).to(device)


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
