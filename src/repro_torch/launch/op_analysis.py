"""Counts of what a step executes: FLOPs, bytes, collectives, live memory.

The counterpart of ``repro.launch.hlo_analysis``.  The reference reads its
numbers off compiled HLO; the port makes no HLO, so it counts the ops that
run, with one ``TorchDispatchMode`` that behaves the same on any device:
on the card, on the CPU and on meta tensors (``launch.dryrun``, which runs
the real steps as one rank of a fake process group).  Eager execution has
no fusion and no loops to multiply out: every op is seen once per
execution, so no trip counts are needed.

What it records, under the reference's names:

* ``flops_by_dtype``: each op's FLOPs by ``torch.utils.flop_counter``'s
  formulas (products and convolutions: 2·|result|·k, as the reference
  counts a dot), keyed by the result's dtype ("f32", "bf16", ...).  The
  hand kernels are ctypes launches that no dispatch mode sees: each
  wrapper reports its own count (``kernels.cuda_lib.counted``, the count
  of the row's bound in ``chip_smoke.py``), the int8 rows under "s32" as
  the reference's HLO tallies an int8 dot, and the ops of its own body (the
  plain version on the CPU) are not counted beside it.
* ``bytes_accessed``: operand plus result bytes of every op (a kernel call:
  its tensor inputs and outputs).  Eager mode materialises every op's
  result, so ``hbm_bytes`` is the same count without the view ops, which
  move nothing.
* ``collective_bytes`` / ``collective_counts`` per kind: the calls that
  ``parallel.collectives`` issued during the analysis and their operand
  bytes, under the reference's names ("collective-permute" for
  ``send_recv``).
* memory: each storage's bytes from the op that creates it until it is
  freed (a finalizer on the storage, so once per storage whatever its
  views), on the arguments' device only (a step's small index tensors
  made on the host are not its memory; moved to the device, they are).
  The storages of the arguments are live throughout; the peak
  of the storages created inside is ``peak_live_bytes``.  The reference's
  ``memory_analysis()`` fields split ``peak_bytes`` = argument + output +
  temp: ``output_size_in_bytes`` the result's new storages,
  ``alias_size_in_bytes`` the result's storages that are arguments (a
  train step updates its state in place), ``temp_size_in_bytes`` the rest
  of the peak.  These are live-storage peaks, the bytes the step's tensors
  hold at once: the card's allocator rounds each block up and keeps
  library workspaces beside them.
"""
from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cuda_lib
from repro_torch.parallel import collectives as C

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "send_recv": "collective-permute"}
_DTYPE = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float16: "f16", torch.int64: "s64", torch.int32: "s32",
          torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
          torch.bool: "pred"}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _dtype_name(dtype: torch.dtype) -> str:
    return _DTYPE.get(dtype, str(dtype).replace("torch.", ""))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpAnalysis(TorchDispatchMode):
    """Counts of the ops run inside the ``with`` block (see the module
    doc).  ``args``: the trees whose storages are the arguments."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = collections.defaultdict(float)
        self.bytes_accessed = 0
        self.hbm_bytes = 0
        self.kernel_calls: Dict[str, int] = collections.Counter()
        self._args: Dict[int, int] = {}
        self.device = None
        for t in cuda_lib.tensors_in(args):
            st = t.untyped_storage()
            self._args[st._cdata] = st.nbytes()
            self.device = self.device or t.device
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._scope = 0
        self._outputs = (0, 0)
        self.collective_counts = {k: 0 for k in COLLECTIVE_KINDS}
        self.collective_bytes = {k: 0 for k in COLLECTIVE_KINDS}

    # ------------------------------------------------------------ the mode
    def __enter__(self):
        self._c0, self._b0 = C.counts(), C.byte_counts()
        cuda_lib.ANALYSES.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            cuda_lib.ANALYSES.remove(self)
            c1, b1 = C.counts(), C.byte_counts()
            for k, kind in _KIND.items():
                self.collective_counts[kind] += c1[k] - self._c0[k]
                self.collective_bytes[kind] += b1[k] - self._b0[k]

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, outs, ins) -> None:
        known = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if self.device is not None and t.device != self.device:
                continue                # host-side indices, not the step's
            st = t.untyped_storage()
            key = st._cdata
            if key in known or key in self._live or key in self._args:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            return out                  # counted by parallel.collectives
        ins = cuda_lib.tensors_in((args, kwargs))
        outs = cuda_lib.tensors_in(out)
        self._track(outs, ins)
        if self._scope:
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None and outs:
            self.flops_by_dtype[_dtype_name(outs[0].dtype)] += count(
                *args, **kwargs, out_val=out)
        n = sum(_nbytes(t) for t in ins + outs)
        self.bytes_accessed += n
        if not func.is_view:
            self.hbm_bytes += n
        return out

    # ------------------------------------------------------------- kernels
    @contextlib.contextmanager
    def kernel_scope(self):
        """Storages tracked, ops not counted (a kernel wrapper's body)."""
        self._scope += 1
        try:
            yield
        finally:
            self._scope -= 1

    def add_kernel(self, name: str, dtype: torch.dtype, ops: int,
                   tensors) -> None:
        self.kernel_calls[name] += 1
        self.flops_by_dtype[_dtype_name(dtype)] += ops
        seen, n = set(), 0
        for t in tensors:
            if id(t) not in seen:
                seen.add(id(t))
                n += _nbytes(t)
        self.bytes_accessed += n
        self.hbm_bytes += n

    # ------------------------------------------------------------- results
    def set_outputs(self, out: Any) -> None:
        """Split the storages of the step's result ``out`` into new ones
        (output) and arguments updated in place (alias)."""
        new = alias = 0
        seen = set()
        for t in cuda_lib.tensors_in(out):
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            if st._cdata in self._args:
                alias += st.nbytes()
            elif st._cdata in self._live:
                new += st.nbytes()
        self._outputs = (new, alias)

    @property
    def argument_bytes(self) -> int:
        return sum(self._args.values())

    def memory_analysis(self) -> Dict[str, int]:
        out, alias = self._outputs
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": out,
                "temp_size_in_bytes": self.peak_live_bytes - out,
                "alias_size_in_bytes": alias,
                "peak_live_bytes": self.peak_live_bytes,
                "peak_bytes": self.argument_bytes + self.peak_live_bytes}

    def summary(self) -> Dict[str, Any]:
        """The reference's ``hlo_analysis.analyze`` keys, and the kernel
        calls."""
        flops = dict(self.flops_by_dtype)
        return {"flops": float(sum(flops.values())),
                "flops_by_dtype": {k: float(v) for k, v in flops.items()},
                "bytes_accessed": float(self.bytes_accessed),
                "hbm_bytes": float(self.hbm_bytes),
                "collective_bytes": {k: float(v) for k, v in
                                     self.collective_bytes.items()},
                "collective_counts": {k: float(v) for k, v in
                                      self.collective_counts.items()},
                "total_collective_bytes": float(
                    sum(self.collective_bytes.values())),
                "kernel_calls": dict(self.kernel_calls)}


def analyze(fn: Callable, *args) -> Tuple[Any, OpAnalysis]:
    """``fn(*args)`` under an ``OpAnalysis`` whose arguments are ``args``:
    (its result, the analysis)."""
    an = OpAnalysis(args)
    with an:
        out = fn(*args)
    an.set_outputs(out)
    return out, an
