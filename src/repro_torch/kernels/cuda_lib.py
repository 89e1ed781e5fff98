"""Build, bind and launch the hand-written CUDA kernels.

Each kernel family keeps one CUDA C++ source for ``sm_90a`` under its
``csrc/`` with plain C entry points.  ``build`` compiles a source with
``nvcc`` at first use into ``build/kernels/`` at the root of the checkout,
named by a hash of the source and its extra flags, so a changed source
builds anew and builds of different sources can run at the same time.
``load`` opens the library with ctypes and declares its entries: every
pointer and the stream as ``c_void_p``, every size as ``c_int``, a scale as
``c_float``, an ``int`` (the CUDA error) back.

The wrappers in ``kernels/<family>/kernel.py`` share the checks below: one
device for all inputs, CPU (the plain version), CUDA (the kernel, which
needs contiguous inputs) or meta (shapes only: the wrapper allocates the
launch path's outputs and temporaries on meta and launches nothing, for
``launch.dryrun``), and a launch that raises on a CUDA error.

``counted`` reports each wrapper call's operation count to the active
``launch.op_analysis`` (a ctypes launch is invisible to a dispatch mode),
on every device: the count of the row's bound in ``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, List, Sequence, Tuple

import torch

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(source: pathlib.Path,
          flags: Sequence[str] = ()) -> Tuple[pathlib.Path, str]:
    """Compile ``source`` (with ``flags`` after the common ones) unless a
    library built from the same bytes and flags exists.  Returns (library
    path, nvcc's messages or "")."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()
                            ).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp),
                           str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)            # atomic: concurrent builders agree
    return lib, proc.stdout + proc.stderr


def load(source: pathlib.Path, entries: Dict[str, List],
         flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``source`` if needed, open it and declare ``entries``."""
    lib = ctypes.CDLL(str(build(source, flags)[0]))
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def expect(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def on_card(family: str, *tensors) -> bool:
    """True to launch; False on the CPU (the plain version) and on meta
    (shapes only); raises on a mix of devices, a device other than CPU,
    CUDA or meta, or a non-contiguous CUDA input."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"inputs on several devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type in ("cpu", "meta"):
        return False
    if dev.type != "cuda":
        raise ValueError(f"{family} kernels run on CUDA, CPU or meta, not "
                         f"{dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{family} kernels need contiguous inputs")
    return True


def launch(lib: ctypes.CDLL, name: str, device, *args) -> None:
    """Call entry ``name`` on the current stream of ``device`` (made the
    current device for the call where it is not); raise if it reports a
    CUDA error."""
    with (contextlib.nullcontext()
          if device.index == torch.cuda.current_device()
          else torch.cuda.device(device)):
        err = getattr(lib, name)(*args,
                                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# Operation counts for launch.op_analysis
# ---------------------------------------------------------------------------

ANALYSES: list = []     # the active op analyses, innermost last


def tensors_in(obj) -> list:
    """The tensors in a nest of tuples, lists and dicts, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in tensors_in(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in tensors_in(o)]
    return []


def counted(ops):
    """Decorate a kernel wrapper: under an active ``launch.op_analysis``,
    each call reports ``ops(*args, **kw)`` → (torch dtype, operation count)
    and the bytes of its tensor inputs and outputs, and the ops of the
    call's own body (the plain version on the CPU, the output allocations
    elsewhere) are not counted beside them; the storages it allocates are
    tracked as any other."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not ANALYSES:
                return fn(*args, **kw)
            an = ANALYSES[-1]
            dtype, n = ops(*args, **kw)
            with an.kernel_scope():
                out = fn(*args, **kw)
            an.add_kernel(fn.__name__, dtype, n,
                          tensors_in((args, kw)) + tensors_in(out))
            return out
        return wrapper
    return wrap
