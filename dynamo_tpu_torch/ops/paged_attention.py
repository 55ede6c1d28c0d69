"""Paged attention over the stacked KV cache (K2 decode, K3 prefill;
``csrc/paged_attention.cu``).

Same entry points, argument order and layouts as the reference:
caches ``[L, n_slots, Hk, Dh]`` (bf16, or int8 with f32 scales
``[L, N, Hk, bs]``), block tables ``[B, W]`` i32, context lengths ``[B]``
i32. The layer is indexed inside the kernel; the stacked cache is never
sliced.

Semantics (both kernels): keys at positions ``< context_lens[b]`` (and,
with a sliding window ``w``, ``> q_pos - w``; prefill is also causal)
are attended with an online softmax in f32. int8 caches: the K scale
multiplies the f32 scores per key, the V scale multiplies the
probabilities, which then round to bf16 before ``P @ V``. Rows without a
valid key give zeros.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors; there is no fallback from one to the other.
``<wrapper>.launches`` counts wrapper calls that launched their kernels
(K2 launches two: the split kernel and the merge kernel).

K2 is split-KV flash-decoding: ``decode_plan`` cuts each sequence's keys
into splits, a function of the host-known sizes only (never a context
length, which would cost a device-to-host copy and change the grid from
step to step), and the kernel writes one f32 partial per live split,
merged in split order by a second kernel. ``decode_split_plain`` is the
same split-and-merge in plain torch, a test oracle for those boundaries.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.kv_quant import gather_slot_scales
from dynamo_tpu_torch.ops.qmatmul import SMS

NEG = -1e30

# K2's launch geometry (csrc/paged_attention.cu, namespace k2)
DECODE_CHUNK = 64  # keys a split block gathers per ring stage (KC)
_DECODE_TABLE = 256  # block-table entries a split block holds (TBL)
_DECODE_MAX_SPLIT = 512  # keys a split at most: finer splits balance the tail
# blocks the grid should have when every key is live: two waves at four
# blocks an SM (the int8 Dh=128 G=4 kernel, at 61 KB of shared memory a
# block, holds three)
_DECODE_MIN_BLOCKS = 2 * 4 * SMS


# ---------------------------------------------------------------------------
# Plain version (CPU path; the oracle the kernels are held to on the card)
# ---------------------------------------------------------------------------


def _gather_layer(cache, scale, layer: int, slot_ids: torch.Tensor, block_size: int):
    """Gathered K or V rows [B, S, Hk, Dh] as f32, with their per-slot
    scales [B, S, Hk] (ones for a float cache)."""
    vals = cache[layer][slot_ids].float()
    if scale is None:
        return vals, torch.ones(vals.shape[:-1], dtype=torch.float32, device=vals.device)
    return vals, gather_slot_scales(scale[layer], slot_ids, block_size, vals.shape[-2])


def paged_attention_plain(
    q: torch.Tensor,  # [B, T, H, Dh]
    k_cache, v_cache, layer: int,
    block_tables: torch.Tensor,  # [B, W]
    q_positions: torch.Tensor,  # [B, T] absolute positions of the queries
    context_lens: torch.Tensor,  # [B]
    block_size: int,
    sliding_window: Optional[int] = None,
    k_scale=None, v_scale=None,
) -> torch.Tensor:
    """Gather-then-attend with the kernels' arithmetic: f32 scores, K
    scale per key, masks at -1e30, exp against the row max, V scale on
    the probabilities before their bf16 rounding, sum floored at 1e-9."""
    B, T, H, Dh = q.shape
    Hk = k_cache.shape[2]
    G = H // Hk
    W = block_tables.shape[1]
    S = W * block_size
    tables = block_tables.long()
    slot_ids = (
        tables[:, :, None] * block_size
        + torch.arange(block_size, device=q.device)[None, None, :]
    ).reshape(B, S)
    keys, ks = _gather_layer(k_cache, k_scale, layer, slot_ids, block_size)
    vals, vs = _gather_layer(v_cache, v_scale, layer, slot_ids, block_size)
    qg = q.float().reshape(B, T, Hk, G, Dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, keys) * (1.0 / math.sqrt(Dh))
    scores = scores * ks.permute(0, 2, 1)[:, :, None, None, :]
    key_pos = torch.arange(S, device=q.device)[None, None, None, None, :]
    pos_q = q_positions.long()[:, None, None, :, None]
    ctx = context_lens.long()[:, None, None, None, None]
    valid = (key_pos <= pos_q) & (key_pos < ctx) & (pos_q < ctx)
    if sliding_window is not None:
        valid = valid & (key_pos > pos_q - sliding_window)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    p = (p * vs.permute(0, 2, 1)[:, :, None, None, :]).to(torch.bfloat16).float()
    out = torch.einsum("bkgts,bskd->btkgd", p, vals) / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, H, Dh).to(q.dtype)


def decode_plan(B: int, Hk: int, W: int, bs: int) -> tuple[int, int]:
    """K2's split of the keys: (keys_per_split, n_splits) for a batch of
    B sequences, Hk KV heads and block tables of W pages of bs tokens.
    The grid is (n_splits, Hk, B); n_splits = ceil(W * bs / keys_per_split).
    Takes the largest split of 512, 256, 128 or 64 keys whose grid has
    at least ``_DECODE_MIN_BLOCKS`` blocks, else 64: few or long
    sequences are cut finer, so they still fill the card. A split spans
    at most ``_DECODE_TABLE`` pages."""
    keys = max(W * bs, 1)
    cap = min(_DECODE_MAX_SPLIT, (_DECODE_TABLE - 2) * bs)
    kps = DECODE_CHUNK
    for cand in (512, 256, 128, 64):
        if cand <= cap and B * Hk * -(-keys // cand) >= _DECODE_MIN_BLOCKS:
            kps = cand
            break
    return kps, -(-keys // kps)


def decode_split_plain(
    q: torch.Tensor,  # [B, H, Dh]
    k_cache, v_cache, layer: int,
    block_tables: torch.Tensor,  # [B, W]
    context_lens: torch.Tensor,  # [B]
    block_size: int,
    sliding_window: Optional[int] = None,
    k_scale=None, v_scale=None,
) -> torch.Tensor:
    """K2's split-and-merge in plain torch (a test oracle; the wrappers
    never call it): the keys in ``[ctx - window, ctx)`` cut at
    ``decode_plan``'s split boundaries; per split the max, p = exp(s - m)
    against it, l = sum p and acc = bf16(p * v_scale) @ V; then the live
    splits merged in split order, out = acc / max(l, 1e-9)."""
    B, H, Dh = q.shape
    Hk = k_cache.shape[2]
    G = H // Hk
    W = block_tables.shape[1]
    S = W * block_size
    kps, n_splits = decode_plan(B, Hk, W, block_size)
    slot_ids = (
        block_tables.long()[:, :, None] * block_size
        + torch.arange(block_size, device=q.device)[None, None, :]
    ).reshape(B, S)
    keys, ks = _gather_layer(k_cache, k_scale, layer, slot_ids, block_size)
    vals, vs = _gather_layer(v_cache, v_scale, layer, slot_ids, block_size)
    qg = q.float().reshape(B, Hk, G, Dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, keys) * (1.0 / math.sqrt(Dh))
    scores = scores * ks.permute(0, 2, 1)[:, :, None, :]
    ctx = context_lens.long()[:, None, None, None]
    lo = (ctx - sliding_window).clamp_min(0) if sliding_window is not None else 0
    key_pos = torch.arange(S, device=q.device)[None, None, None, :]
    valid = (key_pos < ctx) & (key_pos >= lo)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG))
    vsc = vs.permute(0, 2, 1)[:, :, None, :]
    parts = []  # per split: its max, l and acc (zeros past the live keys)
    for i in range(n_splits):
        sl = slice(i * kps, min((i + 1) * kps, S))
        s = scores[..., sl]
        m_i = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid[..., sl], torch.exp(s - m_i), torch.zeros_like(s))
        pv = (p * vsc[..., sl]).to(torch.bfloat16).float()
        parts.append((m_i, p.sum(dim=-1, keepdim=True),
                      torch.einsum("bkgs,bskd->bkgd", pv, vals[:, sl])))
    m = torch.stack([m_i for m_i, _, _ in parts]).amax(dim=0)
    acc = torch.zeros((B, Hk, G, Dh), device=q.device)
    l = torch.zeros((B, Hk, G, 1), device=q.device)
    for m_i, l_i, acc_i in parts:  # in split order
        f = torch.exp(m_i - m)
        acc = acc + acc_i * f
        l = l + l_i * f
    return (acc / l.clamp_min(1e-9)).reshape(B, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.library("paged_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        ll, f = ctypes.c_longlong, ctypes.c_float
        lib.pa_decode_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, ll, i, i, i, i, f, i, p,
        ]
        lib.pa_decode_launch.restype = ctypes.c_int
        lib.pa_prefill_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ll, i, i, i, i, f, p,
        ]
        lib.pa_prefill_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(q, k_cache, v_cache, k_scale, v_scale, block_tables, per_seq, block_size):
    """Validate what the kernels assume; returns (quantized, L, S, Hk, Dh, N)."""
    L, S, Hk, Dh = k_cache.shape
    quantized = k_scale is not None
    if q.dtype != torch.bfloat16:
        raise TypeError(f"attention kernels take bf16 queries, got {q.dtype}")
    want = torch.int8 if quantized else torch.bfloat16
    if k_cache.dtype != want or v_cache.dtype != want:
        raise TypeError(f"cache must be {want} (scales given: {quantized})")
    if tuple(v_cache.shape) != (L, S, Hk, Dh):
        raise ValueError("k_cache and v_cache shapes differ")
    if Dh not in (64, 128):
        raise ValueError(f"head_dim {Dh} not supported by the kernel (64, 128)")
    H = q.shape[-2]
    G = H // Hk if Hk else 0
    if H % Hk or G > 8 or G & (G - 1):
        raise ValueError(f"H/Hk must be a power of two <= 8 (H={H}, Hk={Hk})")
    if S % block_size:
        raise ValueError("cache slots must be a whole number of pages")
    N = S // block_size
    if quantized:
        for s in (k_scale, v_scale):
            if s is None or s.dtype != torch.float32 or tuple(s.shape) != (L, N, Hk, block_size):
                raise ValueError(f"scales must be f32 [{L}, {N}, {Hk}, {block_size}]")
    tensors = [q, k_cache, v_cache, block_tables, *per_seq]
    if quantized:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("attention operands must be contiguous and on one device")
    for t in (block_tables, *per_seq):
        if t.dtype != torch.int32:
            raise TypeError("block tables, starts and context lengths must be int32")
    return quantized, L, S, Hk, Dh, N


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _window(sliding_window: Optional[int]) -> int:
    return int(sliding_window) if sliding_window is not None else 0


# ---------------------------------------------------------------------------
# Public entry points (the reference's signatures, minus ``interpret``)
# ---------------------------------------------------------------------------


def paged_attention_decode_stacked(
    q: torch.Tensor,  # [B, H, Dh]
    k_cache: torch.Tensor,  # [L, n_slots, Hkv, Dh] — the FULL stacked cache
    v_cache: torch.Tensor,
    layer_idx,  # int (or 0-d tensor) — layer to attend over
    block_tables: torch.Tensor,  # [B, W] int32
    context_lens: torch.Tensor,  # [B] int32
    block_size: int,
    sliding_window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [L, N, Hkv, bs] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention ([B, H, Dh]) over layer ``layer_idx`` of the
    stacked cache, one query token per sequence at position ctx - 1."""
    layer = int(layer_idx)
    if not q.is_cuda:
        pos = (context_lens.long() - 1)[:, None]
        return paged_attention_plain(
            q[:, None], k_cache, v_cache, layer, block_tables, pos,
            context_lens, block_size, sliding_window, k_scale, v_scale,
        )[:, 0]
    quantized, L, S, Hk, Dh, N = _check(
        q, k_cache, v_cache, k_scale, v_scale, block_tables, (context_lens,),
        block_size,
    )
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside the {L}-layer cache")
    B, H, _ = q.shape
    W = block_tables.shape[1]
    kps, n_splits = decode_plan(B, Hk, W, block_size)
    if kps % DECODE_CHUNK or n_splits != -(-max(W * block_size, 1) // kps):
        raise ValueError(f"decode plan ({kps}, {n_splits}) does not cut {W * block_size} keys")
    out = torch.empty_like(q)
    # per (sequence, head, split): acc [Dh], then all (m, l) pairs
    ws = torch.empty(B * H * n_splits * (Dh + 2), dtype=torch.float32, device=q.device)
    rc = _lib().pa_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), ws.data_ptr(), int(quantized), layer, B, H, Hk, Dh, S,
        N, block_size, W, _window(sliding_window), 1.0 / math.sqrt(Dh), kps,
        _build.stream_ptr(q.device),
    )
    _build.check(rc, "pa_decode_launch")
    paged_attention_decode_stacked.launches += 1
    return out


def paged_attention_prefill_stacked(
    q: torch.Tensor,  # [B, T, H, Dh] — a (possibly chunked) prefill rectangle
    k_cache: torch.Tensor,  # [L, n_slots, Hkv, Dh] stacked cache
    v_cache: torch.Tensor,
    layer_idx,  # int (or 0-d tensor)
    block_tables: torch.Tensor,  # [B, W] int32
    start_pos: torch.Tensor,  # [B] int32 — absolute position of q[:, 0]
    context_lens: torch.Tensor,  # [B] int32 — total context incl. this chunk
    block_size: int,
    sliding_window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal flash prefill ([B, T, H, Dh]) over the paged cache; the
    chunk's K/V must already be written. q[b, t] sits at start_pos[b] + t;
    rows at or past context_lens[b] give zeros."""
    layer = int(layer_idx)
    if not q.is_cuda:
        T = q.shape[1]
        pos = start_pos.long()[:, None] + torch.arange(T, device=q.device)[None]
        return paged_attention_plain(
            q, k_cache, v_cache, layer, block_tables, pos, context_lens,
            block_size, sliding_window, k_scale, v_scale,
        )
    quantized, L, S, Hk, Dh, N = _check(
        q, k_cache, v_cache, k_scale, v_scale, block_tables,
        (start_pos, context_lens), block_size,
    )
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} outside the {L}-layer cache")
    B, T, H, _ = q.shape
    out = torch.empty_like(q)
    rc = _lib().pa_prefill_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), start_pos.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), int(quantized), layer, B, T,
        H, Hk, Dh, S, N, block_size, block_tables.shape[1],
        _window(sliding_window), 1.0 / math.sqrt(Dh),
        _build.stream_ptr(q.device),
    )
    _build.check(rc, "pa_prefill_launch")
    paged_attention_prefill_stacked.launches += 1
    return out


def paged_attention_decode(
    q: torch.Tensor,  # [B, H, Dh]
    k_cache_l: torch.Tensor,  # [n_slots, Hkv, Dh] (one layer)
    v_cache_l: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    block_size: int,
    sliding_window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [N, Hkv, bs] f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-layer API: the stacked kernel over a one-layer stack (a view)."""
    return paged_attention_decode_stacked(
        q, k_cache_l[None], v_cache_l[None], 0, block_tables, context_lens,
        block_size, sliding_window,
        None if k_scale is None else k_scale[None],
        None if v_scale is None else v_scale[None],
    )


paged_attention_decode_stacked.launches = 0
paged_attention_prefill_stacked.launches = 0
