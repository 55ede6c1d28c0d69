"""int8 KV-cache quantization helpers (kv_cache_dtype="int8").

Per-(token, head) symmetric int8: amax over the head_dim axis sets one f32
scale per written (slot, head); values round half-to-even and clip to
[-127, 127]. Scales are stored ``[L, N, Hk, bs]`` (page-major, then head,
then slot-in-page), the reference's layout, so caches carry across
unchanged; the attention kernels read one page's scales as ``[Hk, bs]``.
"""

from __future__ import annotations

import torch


def kv_scale_shape(
    num_layers: int, num_blocks: int, block_size: int, num_kv_heads: int
) -> tuple[int, int, int, int]:
    return (num_layers, num_blocks, num_kv_heads, block_size)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [..., Hk, Dh]`` float -> (int8 values, f32 scales [..., Hk])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    sc = amax.clamp_min(1e-8) / 127.0
    q = torch.round(xf / sc[..., None]).clamp(-127, 127).to(torch.int8)
    return q, sc


def scale_scatter_indices(
    slot_mapping: torch.Tensor, block_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat slot ids [M] -> (pages [M], offsets [M]) addressing the
    [L, N, Hk, bs] scale array."""
    return slot_mapping // block_size, slot_mapping % block_size


def gather_slot_scales(
    scales_l: torch.Tensor,  # [N, Hk, bs] one layer's scales
    slot_ids: torch.Tensor,  # [...] flat slot ids
    block_size: int,
    num_kv_heads: int,
) -> torch.Tensor:
    """Per-slot scales [..., Hk] for the gather-then-attend path."""
    n = (slot_ids // block_size).long()
    off = (slot_ids % block_size).long()
    # [..., Hk, bs] page tiles -> the slot's column
    tiles = scales_l[n]
    return torch.gather(
        tiles, -1, off[..., None, None].expand(*off.shape, num_kv_heads, 1)
    )[..., 0]
