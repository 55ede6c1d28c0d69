"""Weight-only int8 quantization for the serving path.

Symmetric per-channel int8: each matmul weight stores an int8 tensor plus
an f32 scale per output channel (per vocab row for the embedding table):
scale = amax/127 over the contraction axis (floored at 1e-12), values
round half-to-even and clip to [-127, 127]. Same names, axes and
numerics as the reference, so quantized parameters carry across.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

# weight name -> contraction axis reduced over when computing scales
# (the scale then broadcasts over the matmul output's channel axis)
QUANT_AXIS: dict[str, int] = {
    "wq": -2,
    "wk": -2,
    "wv": -2,
    "wo": -2,
    "w_gate": -2,
    "w_up": -2,
    "w_down": -2,
    "lm_head": -2,
    # embedding rows are gathered, not contracted: per-row scales
    "embed": -1,
}

SCALE_SUFFIX = "_scale"


def np_to_f32(arr: np.ndarray) -> np.ndarray:
    """Checkpoint array -> f32, handling bf16 stored as raw uint16."""
    if arr.dtype == np.uint16:
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(arr, np.float32)


def quantize_array(arr: np.ndarray, axis: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8: -> (int8 values, f32 scales with
    ``axis`` dropped)."""
    a = np_to_f32(arr)
    amax = np.max(np.abs(a), axis=axis, keepdims=True)
    scale = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return q, np.squeeze(scale, axis=axis).astype(np.float32)


def quantize_tensor(arr: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_array`` on a device tensor (f32 in, int8 + f32 out)."""
    amax = arr.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(arr / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def _generators(seed: int, device: torch.device, n: int) -> list[torch.Generator]:
    gens = []
    for i in range(n):
        g = torch.Generator(device=device)
        g.manual_seed(seed * 1_000_003 + i)
        gens.append(g)
    return gens


def init_params_quantized(cfg, seed: int = 0, device="cuda") -> dict[str, Any]:
    """Random-init already-quantized params (tests and benchmarks without
    a checkpoint). Each stacked weight is generated in f32 and quantized
    on ``device`` one layer at a time, into preallocated int8 and scale
    tensors: the bf16 or f32 model is never materialized, so the f32
    transient is one layer's weight (the 8B bf16 model would not leave
    room for a KV cache next to its int8 form). Normal(0, 1/sqrt(fan_in))
    weights, ones for norms; a seeded ``torch.Generator`` per tensor."""
    from dynamo_tpu_torch.models.llama import param_shapes

    device = torch.device(device)
    shapes = param_shapes(cfg)
    gens = _generators(seed, device, len(shapes))
    params: dict[str, Any] = {}
    for gen, (name, (shape, dtype)) in zip(gens, shapes.items()):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = 1.0 / math.sqrt(max(1, fan_in))
        if name not in QUANT_AXIS:
            if name.endswith("norm"):
                params[name] = torch.ones(shape, dtype=dtype, device=device)
            else:
                params[name] = (
                    torch.randn(shape, generator=gen, device=device) * std
                ).to(dtype)
            continue
        axis = QUANT_AXIS[name]
        scale_shape = tuple(d for j, d in enumerate(shape) if j != len(shape) + axis)
        q_arr = torch.empty(shape, dtype=torch.int8, device=device)
        s_arr = torch.empty(scale_shape, dtype=torch.float32, device=device)
        slices = range(shape[0]) if len(shape) >= 3 else [None]
        for j in slices:
            sub = shape[1:] if j is not None else shape
            w = torch.randn(sub, generator=gen, device=device) * std
            q, s = quantize_tensor(w, axis)
            if j is None:
                q_arr.copy_(q)
                s_arr.copy_(s)
            else:
                q_arr[j].copy_(q)
                s_arr[j].copy_(s)
            del w, q, s
        params[name] = q_arr
        params[name + SCALE_SUFFIX] = s_arr
    return params


def init_params(cfg, seed: int = 0, device="cuda") -> dict[str, Any]:
    """Random-init bf16 params (norms f32 ones), one seeded generator per
    tensor, generated slice by slice on ``device``."""
    from dynamo_tpu_torch.models.llama import param_shapes

    device = torch.device(device)
    shapes = param_shapes(cfg)
    gens = _generators(seed, device, len(shapes))
    params: dict[str, Any] = {}
    for gen, (name, (shape, dtype)) in zip(gens, shapes.items()):
        if name.endswith("norm"):
            params[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = 1.0 / math.sqrt(max(1, fan_in))
        arr = torch.empty(shape, dtype=dtype, device=device)
        for j in range(shape[0]) if len(shape) >= 3 else [None]:
            sub = shape[1:] if j is not None else shape
            w = (torch.randn(sub, generator=gen, device=device) * std).to(dtype)
            (arr if j is None else arr[j]).copy_(w)
        params[name] = arr
    return params
