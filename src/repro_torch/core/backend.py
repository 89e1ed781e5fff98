"""Pluggable execution backends for the quantized primitives.

The counterpart of ``repro.core.backend``: the same ``Backend`` fields and
the same selection precedence (most specific wins):

  1. per-call   ``dependable_qconv2d(..., backend="ref")``
  2. per-layer  per-layer lists in ``models/shipdet.forward``;
                ``cfg.backend`` of the transformer
  3. global     ``set_default_backend`` / ``use_backend`` context manager

All three accept either a backend name or a ``Backend`` instance.  Three
backends are built in (``kernels/dispatch.py`` registers them), the
counterparts of the reference's ``jnp``, ``ref`` and ``pallas``:

  torch  whole-tensor float64 matmul and ``F.conv2d`` (exact below 2^53),
         rounded to int64 and wrapped mod 2^32; no hand kernel
  ref    independent plain-PyTorch oracle (exact float64 products, tap loop,
         exact integer sums, explicit mod-2^32 wrap)
  cuda   the hand-written Hopper kernels; on CPU tensors their wrappers run
         the kernels' plain versions, on CUDA tensors they launch or raise

``cuda`` is the global default.  The hot path is integer (int8 × int8 →
int32, exact mod 2^32), so the backends are bit-identical there; their
attention is float and agrees to a tolerance.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

BackendLike = Union[str, "Backend", None]


@dataclasses.dataclass(frozen=True)
class Backend:
    """One execution engine for the quantized primitives.

    All entries are accumulator-level (no bias, no requantization):

      conv_acc(x_q i8 NHWC, x_zp i32, w_q i8 HWIO, stride, padding)
          -> i32 (N,OH,OW,Cout): conv(x_q - x_zp, w_q)
      conv_acc_checksum(x_q, x_zp, w_q, w_check i32 (KH,KW,Cin,1),
                        stride, padding) -> (acc, want (N,OH,OW))
      matmul_acc(x_q i8 (M,K), w_q i8 (K,N)) -> i32 (M,N)
      matmul_acc_checksum(x_q, w_q, w_check i32 (K,)) -> (acc, want (M,))
      attn(q f32/bf16 (B,H,S,hd), k, v (B,KV,S,hd), *, causal, window)
          -> out like q
      attn_checksum(q, k, v, *, causal, window)
          -> (out, check f32 (B,H,S), csum int64 (B,H,S) in [0, 2^32))

    An out-of-tree backend may leave the attention entries ``None``;
    ``dependable_attention`` then refuses it.
    """

    name: str
    conv_acc: Callable[..., torch.Tensor]
    conv_acc_checksum: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    description: str = ""
    matmul_acc: Optional[Callable[..., torch.Tensor]] = None
    matmul_acc_checksum: Optional[
        Callable[..., Tuple[torch.Tensor, torch.Tensor]]] = None
    attn: Optional[Callable[..., torch.Tensor]] = None
    attn_checksum: Optional[
        Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]] = None


_REGISTRY: Dict[str, Backend] = {}
# thread-local so `use_backend` nesting in concurrent callers can't bleed a
# temporary default across threads
_STATE = threading.local()
_GLOBAL_DEFAULT = "cuda"


def register_backend(backend: Backend, *, overwrite: bool = False) -> Backend:
    """Add a backend to the registry (how out-of-tree engines plug in)."""
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[backend.name] = backend
    return backend


def _ensure_builtins() -> None:
    # Lazy so core/ never imports kernels/ at module load (no cycle).
    if "cuda" not in _REGISTRY:
        from repro_torch.kernels import dispatch  # noqa: F401  (registers)


def available_backends() -> List[str]:
    """Registered backend names, built-ins guaranteed present."""
    _ensure_builtins()
    return sorted(_REGISTRY)


def get_backend(name: str) -> Backend:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; known: {sorted(_REGISTRY)}"
                       ) from None


def default_backend() -> str:
    """The currently active global default (innermost ``use_backend`` wins)."""
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else _GLOBAL_DEFAULT


def set_default_backend(name: str) -> None:
    """Set the process-wide default backend (validated)."""
    global _GLOBAL_DEFAULT
    get_backend(name)
    _GLOBAL_DEFAULT = name


@contextlib.contextmanager
def use_backend(name: str):
    """Scoped global selection: every op inside the block that does not get
    a more specific (per-layer / per-call) choice runs on ``name``."""
    get_backend(name)
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def resolve(backend: BackendLike = None) -> Backend:
    """Per-call > per-layer > global precedence collapses to one rule: the
    most specific non-None choice reaches this function first."""
    if isinstance(backend, Backend):
        return backend
    return get_backend(backend if backend is not None else default_backend())
