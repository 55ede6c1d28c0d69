"""int8-weight x bf16-activation matmuls (K1, ``csrc/qmm.cu``).

The port of the reference's fused dequant matmuls: ``qmm`` (plain, or
with the residual add fused into the epilogue), ``qmm_gate_up`` (both MLP
weights in one pass, act(gate) * up in the epilogue) and ``qmm_lm_head``.
Same signatures and layouts as the reference, minus the TPU's
``interpret``/``tiles`` knobs: x ``[..., K]``, w ``[K, N]`` int8, scale
``[N]`` f32, output ``[..., N]`` in x's dtype.

Numerics contract: the int8 -> bf16 upcast is exact, products accumulate
in f32, the per-channel scale applies to the f32 sum, and the output
rounds to the activation dtype at the reference's points: before the
residual add (which then runs in the output dtype), and for gate_up on
each of g and u before the activation, again after it, and after the
product. Remaining differences from the reference are accumulation order.

Each wrapper launches the CUDA kernel for CUDA tensors (bf16 activations)
and runs its plain version (``*_plain``) for CPU tensors; there is no
fallback from one to the other. ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops import _build

_EPI = {"": 0, "residual": 1, "gate_up": 2}
_ACT = {"silu": 0, "gelu": 1}
# the kernel's tile geometry (csrc/qmm.cu: BM, BN, BK)
_BM, _BN, _BK = 64, 64, 64
# blocks worth launching before K is split across blocks: ~2 per SM
_TARGET_BLOCKS = 264
_MAX_SPLITS = 16


def act_fn(name: str, g: torch.Tensor) -> torch.Tensor:
    """Gate activation (same failure contract as the reference: an unknown
    activation raises rather than silently serving silu)."""
    if name == "gelu":
        return F.gelu(g, approximate="tanh")
    if name == "silu":
        return F.silu(g)
    raise ValueError(f"unsupported activation {name!r}")


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the oracle the kernel is held to on the card)
# ---------------------------------------------------------------------------


def _dequant_mm(x2: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (x2.float() @ w.float()) * s.float()


def qmm_plain(x2, w, s, residual2=None):
    y = _dequant_mm(x2, w, s).to(x2.dtype)
    return y if residual2 is None else residual2 + y


def qmm_gate_up_plain(x2, w_gate, gate_scale, w_up, up_scale, act="silu"):
    g = _dequant_mm(x2, w_gate, gate_scale).to(x2.dtype)
    u = _dequant_mm(x2, w_up, up_scale).to(x2.dtype)
    return act_fn(act, g) * u


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def split_plan(M: int, N: int, K: int) -> tuple[int, int]:
    """(splits, K per split): split K only when the output tiles alone
    leave the card short of blocks (decode); each split a multiple of BK."""
    tiles = -(-M // _BM) * -(-N // _BN)
    nk = -(-K // _BK)
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles), nk, _MAX_SPLITS))
    kps = -(-nk // splits) * _BK
    return -(-K // kps), kps


def _lib():
    lib = _build.library("qmm")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.qmm_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_operands(x2, weights, scales, residual2):
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"qmm kernel takes bf16 activations, got {x2.dtype}")
    K = x2.shape[1]
    N = weights[0].shape[1]
    for w, s in zip(weights, scales):
        if w.dtype != torch.int8 or tuple(w.shape) != (K, N):
            raise ValueError(f"weight must be int8 [{K}, {N}], got {w.dtype} {tuple(w.shape)}")
        if s.dtype != torch.float32 or tuple(s.shape) != (N,):
            raise ValueError(f"scale must be f32 [{N}], got {s.dtype} {tuple(s.shape)}")
    tensors = [x2, *weights, *scales] + ([residual2] if residual2 is not None else [])
    for t in tensors:
        if t.device != x2.device:
            raise ValueError("qmm operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("qmm operands must be contiguous")
    if residual2 is not None and (
        residual2.dtype != x2.dtype or tuple(residual2.shape) != (x2.shape[0], N)
    ):
        raise ValueError("residual must match the output's shape and dtype")


def _launch(x2, weights, scales, residual2, fused: str, act: str) -> torch.Tensor:
    _check_operands(x2, weights, scales, residual2)
    M, K = x2.shape
    N = weights[0].shape[1]
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    splits, kps = split_plan(M, N, K)
    part = None
    if splits > 1:
        n_planes = splits * (2 if fused == "gate_up" else 1)
        part = torch.empty((n_planes, M, N), dtype=torch.float32, device=x2.device)
    w2 = weights[1] if fused == "gate_up" else None
    s2 = scales[1] if fused == "gate_up" else None
    rc = _lib().qmm_launch(
        x2.data_ptr(), weights[0].data_ptr(), scales[0].data_ptr(),
        w2.data_ptr() if w2 is not None else None,
        s2.data_ptr() if s2 is not None else None,
        residual2.data_ptr() if residual2 is not None else None,
        out.data_ptr(), part.data_ptr() if part is not None else None,
        M, N, K, _EPI[fused], _ACT[act], splits, kps,
        _build.stream_ptr(x2.device),
    )
    _build.check(rc, "qmm_launch")
    return out


def _flatten(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    return x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])


# ---------------------------------------------------------------------------
# Public entry points (the reference's signatures)
# ---------------------------------------------------------------------------


def qmm(
    x: torch.Tensor,  # [..., K] float activations
    w: torch.Tensor,  # [K, N] int8
    scale: torch.Tensor,  # [N] f32 per-output-channel dequant scale
    residual: Optional[torch.Tensor] = None,  # [..., N] fused epilogue add
    kind: str = "mm",
) -> torch.Tensor:
    """y = (x @ w) * scale (+ residual), rounded to x.dtype. ``kind`` is
    accepted for signature parity with the reference (its tune key)."""
    del kind
    x2, lead = _flatten(x)
    r2 = None if residual is None else residual.reshape(-1, w.shape[1])
    if x2.is_cuda:
        y = _launch(
            x2.contiguous(), [w], [scale],
            None if r2 is None else r2.contiguous(),
            "residual" if r2 is not None else "", "silu",
        )
        qmm.launches += 1
    else:
        y = qmm_plain(x2, w, scale, r2)
    return y.reshape(*lead, w.shape[1])


def qmm_gate_up(
    x: torch.Tensor,  # [..., D]
    w_gate: torch.Tensor,  # [D, F] int8
    gate_scale: torch.Tensor,  # [F] f32
    w_up: torch.Tensor,  # [D, F] int8
    up_scale: torch.Tensor,  # [F] f32
    act: str = "silu",
) -> torch.Tensor:
    """act(x @ Wg * sg) * (x @ Wu * su): both MLP weights in one pass; the
    [..., F] gate/up intermediates never reach device memory."""
    if act not in _ACT:
        raise ValueError(f"unsupported activation {act!r}")
    x2, lead = _flatten(x)
    if x2.is_cuda:
        y = _launch(
            x2.contiguous(), [w_gate, w_up], [gate_scale, up_scale], None,
            "gate_up", act,
        )
        qmm_gate_up.launches += 1
    else:
        y = qmm_gate_up_plain(x2, w_gate, gate_scale, w_up, up_scale, act)
    return y.reshape(*lead, w_gate.shape[1])


def qmm_lm_head(
    x: torch.Tensor,  # [..., D] final hidden states
    w: torch.Tensor,  # [D, V] int8
    scale: torch.Tensor,  # [V] f32
) -> torch.Tensor:
    """The LM-head qmm (at V=128256 the largest weight read of a decode
    step). Output rounds to x.dtype like ``mm``; the caller upcasts."""
    x2, lead = _flatten(x)
    if x2.is_cuda:
        y = _launch(x2.contiguous(), [w], [scale], None, "", "silu")
        qmm_lm_head.launches += 1
    else:
        y = qmm_plain(x2, w, scale)
    return y.reshape(*lead, w.shape[1])


qmm.launches = 0
qmm_gate_up.launches = 0
qmm_lm_head.launches = 0
