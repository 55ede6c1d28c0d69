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
launches. ``launch_plan`` is the kernel's launch configuration as a pure
function of the shape, so that the CPU tests can check it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops import _build

_EPI = {"": 0, "residual": 1, "gate_up": 2}
_ACT = {"silu": 0, "gelu": 1}
# the kernel's launch geometry (csrc/qmm.cu: BK, Cfg, MAX_SPLITS)
_BK = 64  # K per pipeline step
SMS = 132  # streaming multiprocessors of an H100 SXM
DECODE_MAX_M = 64  # M at or below: the decode configuration
MAX_PORTABLE_CLUSTER = 8
MAX_CLUSTER = 16  # needs the non-portable cluster size attribute above 8
# kernel variant: (configuration, rows per block, W columns staged per step)
_VARIANTS = (("prefill", 128, 256), ("decode", 64, 128), ("decode", 64, 64))
# Clusters of 1, 2, ... blocks that one H100 SXM (132 SMs) holds at once,
# per variant: cudaOccupancyMaxActiveClusters, which chip_smoke.py prints
# (csrc/qmm.cu: qmm_max_clusters). A cluster's blocks share a GPC, so
# large clusters strand SMs: 14 decode clusters of 16 fit, not 16.5. A
# prefill block fills its SM, so its clusters stop at the portable 8.
_DECODE_CLUSTERS = (264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14)
_CLUSTERS_AT_ONCE = ((132, 66, 39, 30, 22, 17, 15, 15), _DECODE_CLUSTERS, _DECODE_CLUSTERS)


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


class Plan(NamedTuple):
    variant: int  # kernel instance (csrc/qmm.cu: CFG_*)
    config: str  # "prefill" or "decode"
    bm: int  # output rows per block
    bn: int  # output columns per block
    splits: int  # blocks of one cluster that split K
    grid: tuple[int, int]  # (M tiles x splits, N tiles)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def nonportable(self) -> bool:
        return self.splits > MAX_PORTABLE_CLUSTER


def launch_plan(M: int, N: int, K: int, epilogue: str = "") -> Plan:
    """The kernel's configuration for x [M, K] @ W [K, N]. Prefill above
    DECODE_MAX_M rows, decode at or below. Decode stages 128 W columns a
    step (64 of each weight for gate_up), or 64 where N is too narrow for
    128-column tiles to fill the card even split 16 ways. K is split
    across the blocks of a cluster as far as every cluster still runs at
    once (a second wave of clusters would double the time)."""
    two = epilogue == "gate_up"
    if M > DECODE_MAX_M:
        variant = 0
    elif two or -(-N // 128) * MAX_CLUSTER >= SMS:
        variant = 1
    else:
        variant = 2
    config, bm, staged = _VARIANTS[variant]
    bn = staged // 2 if two else staged
    tiles_m, tiles_n = -(-M // bm), -(-N // bn)
    capacity = _CLUSTERS_AT_ONCE[variant]
    splits = 1
    for s in range(2, min(len(capacity), -(-K // _BK)) + 1):
        if tiles_m * tiles_n <= capacity[s - 1]:
            splits = s
    return Plan(variant, config, bm, bn, splits, (tiles_m * splits, tiles_n))


def clusters_at_once(plan: Plan) -> int:
    """How many of the plan's clusters the card runs at once."""
    return _CLUSTERS_AT_ONCE[plan.variant][plan.splits - 1]


def split_steps(K: int, splits: int) -> list[range]:
    """The 64-deep K steps each cluster rank runs (the kernel's formula)."""
    nk = -(-K // _BK)
    return [range(r * nk // splits, (r + 1) * nk // splits) for r in range(splits)]


def _lib():
    lib = _build.library("qmm")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.qmm_launch.restype = ctypes.c_int
        lib.qmm_smem_bytes.argtypes = [i, i]
        lib.qmm_smem_bytes.restype = ctypes.c_int
        lib.qmm_max_clusters.argtypes = [i, i]
        lib.qmm_max_clusters.restype = ctypes.c_int
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
    plan = launch_plan(M, N, K, fused)
    w2 = weights[1] if fused == "gate_up" else None
    s2 = scales[1] if fused == "gate_up" else None
    rc = _lib().qmm_launch(
        x2.data_ptr(), weights[0].data_ptr(), scales[0].data_ptr(),
        w2.data_ptr() if w2 is not None else None,
        s2.data_ptr() if s2 is not None else None,
        residual2.data_ptr() if residual2 is not None else None,
        out.data_ptr(), M, N, K, _EPI[fused], _ACT[act], plan.variant, plan.splits,
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
