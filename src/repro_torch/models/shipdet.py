"""Ship Detection CNN — the paper's own workload (OBPMark-ML, YoloX-style).

The counterpart of ``repro.models.shipdet``: the same layer specs, the same
parameter layout (one dict per layer with a ``QConvParams`` bundle and
static activation qparams) and the same ``forward`` keywords, apart from
the TPU-only ``use_kernel`` and ``interpret``.  Every convolution runs as
int8 conv + fused re-quantization; the dependability policy applies per
layer (``core/dependability``).  Activations are NHWC, weights HWIO.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import abft as abft_mod
from repro_torch.core import quant
from repro_torch.core.dependability import (
    DependabilityStats, Policy, dependable_qconv2d)
from repro_torch.kernels.qconv2d import ops as qconv_ops


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    kh: int
    kw: int
    cin: int
    cout: int
    h: int                 # input spatial (square images per the paper's table)
    w: int
    stride: int = 1

    @property
    def macs(self) -> int:
        return self.h * self.w * self.cin * self.cout * self.kh * self.kw // (self.stride ** 2)


# The paper's Table-1 layers, exact geometry.
TABLE1_LAYERS = [
    ConvSpec("conv_24x3x3x24", 3, 3, 24, 24, 194, 194),
    ConvSpec("conv_48x3x3x48", 3, 3, 48, 48, 98, 98),
    ConvSpec("conv_96x3x3x96", 3, 3, 96, 96, 50, 50),
    ConvSpec("conv_96x1x1x96", 1, 1, 96, 96, 96, 96),
]


def network_specs(img: int = 194) -> List[ConvSpec]:
    """Full ship-detector: stem + Table-1 trunk + head."""
    return [
        ConvSpec("stem", 3, 3, 3, 24, img * 2, img * 2, stride=2),
        TABLE1_LAYERS[0],
        ConvSpec("down1", 3, 3, 24, 48, 194, 194, stride=2),
        TABLE1_LAYERS[1],
        ConvSpec("down2", 3, 3, 48, 96, 98, 98, stride=2),
        TABLE1_LAYERS[2],
        ConvSpec("head1x1", 1, 1, 96, 96, 50, 50),
        ConvSpec("det_head", 1, 1, 96, 6, 50, 50),     # 1 class + 4 box + obj
    ]


def reduced_specs() -> List[ConvSpec]:
    """Small variant for CPU tests (same topology, 8× smaller maps)."""
    return [dataclasses.replace(s, h=max(s.h // 8, 4), w=max(s.w // 8, 4))
            for s in network_specs()]


def _layer_qparams(device) -> Dict[str, torch.Tensor]:
    # static calibration (identity-ish ranges), as in the reference
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return {"in_scale": torch.tensor(0.05, **f32),
            "in_zp": torch.tensor(0, **i32),
            "out_scale": torch.tensor(0.05, **f32),
            "out_zp": torch.tensor(0, **i32)}


def init_params(specs: List[ConvSpec], generator: torch.Generator,
                device="cuda") -> List[Dict[str, Any]]:
    """Float master weights (drawn from ``generator`` on the host, then moved
    to ``device``) + static activation qparams per layer."""
    dev = resolve_device(device)
    params = []
    for s in specs:
        w = torch.randn((s.kh, s.kw, s.cin, s.cout), generator=generator,
                        dtype=torch.float32)
        w = (w * (1.0 / math.sqrt(s.kh * s.kw * s.cin))).to(dev)
        b = torch.zeros((s.cout,), dtype=torch.float32, device=dev)
        params.append({"qconv": qconv_ops.make_qconv_params(w, b),
                       **_layer_qparams(dev)})
    return params


def deploy_checks(params: List[Dict[str, Any]]) -> List[torch.Tensor]:
    """Deploy-time per-layer weight checksums over the known-good quantized
    weights; ``forward(w_checks=)`` verifies the live weights against them."""
    return [abft_mod.conv_checksum_weight(p["qconv"].w_q) for p in params]


def golden_weights(params: List[Dict[str, Any]]) -> List[torch.Tensor]:
    """The known-good quantized weights per layer — the operand checkpoint
    CKPT rolls back to when a deploy-time check fails."""
    return [p["qconv"].w_q.clone() for p in params]


def forward(specs: List[ConvSpec], params: List[Dict[str, Any]],
            x: torch.Tensor, *, policy: Policy = Policy.NONE,
            policy_map=None, inject=None, inject_layer=None, backend=None,
            w_checks: Optional[List[torch.Tensor]] = None,
            golden_wq: Optional[List[torch.Tensor]] = None,
            ) -> Tuple[torch.Tensor, Dict]:
    """x: (N, H, W, 3) float in [0,1]. Returns (det map, dependability stats).

    With no policy, map, injection or backend, each layer runs the fused
    kernel (``qconv_act``).  Otherwise each layer runs
    ``dependable_qconv2d`` on ``backend`` (a name network-wide, or a
    sequence per layer).  ``w_checks`` (from ``deploy_checks``) makes the
    ABFT/CKPT checks verify against the deploy-time checksums;
    ``golden_wq`` (from ``golden_weights``) gives CKPT a rollback target.
    ``policy_map`` assigns a policy (and backend) per layer by
    ``ConvSpec.name``, with DMR/TMR run in the op; without a map, DMR/TMR
    run each layer's plain path as in the reference.  ``inject`` corrupts
    the accumulator of layer ``inject_layer`` (default: the middle one).
    """
    if policy_map is not None and policy is not Policy.NONE:
        raise ValueError("pass either policy= or policy_map=, not both")
    stats = DependabilityStats.zero(x.device)
    if backend is None or isinstance(backend, str):
        layer_backends = [backend] * len(specs)
    else:
        layer_backends = list(backend)
        if len(layer_backends) != len(specs):
            raise ValueError(f"{len(layer_backends)} backends for "
                             f"{len(specs)} layers")
    hook_layer = len(specs) // 2 if inject_layer is None else inject_layer
    for i, (s, p) in enumerate(zip(specs, params)):
        stride = (s.stride, s.stride)
        layer_be = layer_backends[i]
        layer_inject = inject if i == hook_layer else None
        if policy_map is not None:
            layer_policy, pm_backend = policy_map.resolve(s.name)
            layer_be = pm_backend or layer_be
            in_op_policy = layer_policy
        else:
            layer_policy = policy
            # ABFT and CKPT run inside the op; NMR policies replicate at the
            # network level, so their per-layer call is the plain path
            in_op_policy = policy if policy in (Policy.ABFT, Policy.CKPT) \
                else Policy.NONE
        if layer_policy != Policy.NONE or layer_inject is not None \
                or layer_be is not None:
            x_q = quant.quantize(x, p["in_scale"], p["in_zp"])
            bias_i32 = torch.round(
                p["qconv"].bias_f / (p["in_scale"] * p["qconv"].w_scale)
            ).to(torch.int32)
            rq = quant.requant_scale(p["in_scale"], p["qconv"].w_scale,
                                     p["out_scale"])
            y_q, lstats = dependable_qconv2d(
                in_op_policy,
                x_q, p["in_zp"], p["qconv"].w_q, bias_i32, rq, p["out_zp"],
                stride=stride, padding="SAME", inject=layer_inject,
                backend=layer_be,
                w_check=w_checks[i] if w_checks is not None else None,
                ckpt=((x_q, golden_wq[i]) if golden_wq is not None
                      else None))
            x = (y_q.to(torch.float32) - p["out_zp"]) * p["out_scale"]
            stats = DependabilityStats.merge(stats, lstats)
        else:
            x = qconv_ops.qconv_act(
                x, p["qconv"], p["in_scale"], p["in_zp"],
                p["out_scale"], p["out_zp"], stride=stride, padding="SAME")
        if i < len(specs) - 1:
            x = torch.relu(x)
    return x, stats


def _float_conv_same(x: torch.Tensor, w: torch.Tensor, stride) -> torch.Tensor:
    """Float NHWC × HWIO conv with SAME padding (asymmetric for stride 2),
    in full float32 on the card (cuDNN would otherwise use TF32)."""
    (ph0, ph1), (pw0, pw1) = qconv_ops.resolve_pads(
        x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride, "SAME")
    xn = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return y.permute(0, 2, 3, 1)


def layer_forward(s: ConvSpec, p: Dict[str, Any], x: torch.Tensor,
                  quantized: bool = True) -> torch.Tensor:
    """One layer, float in → float out; quantized=False is the float oracle
    (dequantized weights, float conv)."""
    stride = (s.stride, s.stride)
    if quantized:
        return qconv_ops.qconv_act(
            x, p["qconv"], p["in_scale"], p["in_zp"],
            p["out_scale"], p["out_zp"], stride=stride, padding="SAME")
    w = p["qconv"].w_q.to(torch.float32) * p["qconv"].w_scale
    return _float_conv_same(x, w, stride) + p["qconv"].bias_f


def float_forward(specs: List[ConvSpec], params: List[Dict[str, Any]],
                  x: torch.Tensor) -> torch.Tensor:
    """Float-oracle network forward (dequantized weights)."""
    for i, (s, p) in enumerate(zip(specs, params)):
        x = layer_forward(s, p, x, quantized=False)
        if i < len(specs) - 1:
            x = torch.relu(x)
    return x
