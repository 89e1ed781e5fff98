"""PyTorch/CUDA port of the ``repro`` package.

The layout and public names follow ``repro`` (``core/``, ``kernels/``,
``models/``, ``configs/``, ``runtime/``) so that each module's counterpart
is easy to find, and the public functions keep its layouts: NHWC
activations and HWIO weights for the CNN, (M,K)·(K,N) int8 matmuls,
(L, B, T, KV, hd) KV caches and stacked (L, ...) parameter dicts for the
transformer.  Entry
points take an explicit ``device`` (default ``"cuda"``); asking for the card
where there is none raises, and nothing drops to the CPU on its own.  The
hand-written kernels run on CUDA tensors; their plain PyTorch versions run
only on CPU tensors, which is how the tests hold the port against ``repro``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain versions")
    return dev
