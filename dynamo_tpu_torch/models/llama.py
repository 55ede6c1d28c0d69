"""Llama-family dense decoder in PyTorch over a paged KV cache.

The port of the reference decoder's serving path: same parameter names,
shapes and dtypes (layers stacked on a leading L axis), same cache layout
(``[L, n_slots, Hk, Dh]``; int8 caches are (values, scales) pairs with
scales ``[L, N, Hk, bs]``), same rounding points. One ``forward`` serves
prefill and decode: write the new K/V into the cache at ``slot_mapping``,
then attend through the paged-attention kernels, which index layer ``i``
of the stacked cache themselves.

The layer loop is a Python loop over the stacked parameters. Matmuls on
int8 weights go through the K1 wrappers (``ops/qmatmul.py``), attention
through K2 (decode, T == 1) and K3 (prefill); every wrapper runs its
CUDA kernel for CUDA tensors and its plain version on the CPU. rmsnorm,
rope, the embedding gather and the KV quantize + scatter are plain torch,
as they are plain XLA in the reference. MoE and pipeline parallelism are
not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.kv_quant import (
    gather_slot_scales,
    kv_scale_shape,
    quantize_kv,
    scale_scatter_indices,
)
from dynamo_tpu_torch.ops.paged_attention import (
    NEG,
    paged_attention_decode_stacked,
    paged_attention_prefill_stacked,
)
from dynamo_tpu_torch.ops.qmatmul import act_fn, qmm, qmm_gate_up, qmm_lm_head

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Parameters and cache
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype). Layer params carry a leading L axis."""
    L, D = cfg.num_hidden_layers, cfg.hidden_size
    H, Hk, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    F, V = cfg.intermediate_size, cfg.vocab_size
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = {
        "embed": ((V, D), bf16),
        "attn_norm": ((L, D), f32),
        "wq": ((L, D, H * Dh), bf16),
        "wk": ((L, D, Hk * Dh), bf16),
        "wv": ((L, D, Hk * Dh), bf16),
        "wo": ((L, H * Dh, D), bf16),
        "mlp_norm": ((L, D), f32),
        "final_norm": ((D,), f32),
        "lm_head": ((D, V), bf16),
    }
    if cfg.attention_bias:
        shapes.update({
            "bq": ((L, H * Dh), bf16),
            "bk": ((L, Hk * Dh), bf16),
            "bv": ((L, Hk * Dh), bf16),
        })
    if cfg.is_moe:
        raise NotImplementedError("MoE models are not ported yet")
    shapes.update({
        "w_gate": ((L, D, F), bf16),
        "w_up": ((L, D, F), bf16),
        "w_down": ((L, F, D), bf16),
    })
    return shapes


def cache_shape(cfg: ModelConfig, num_blocks: int, block_size: int) -> tuple[int, int, int, int]:
    """KV cache per K and V: [L, num_blocks*block_size, Hkv, Dh]."""
    return (
        cfg.num_hidden_layers,
        num_blocks * block_size,
        cfg.num_key_value_heads,
        cfg.head_dim,
    )


def kv_cache_is_quantized(cache) -> bool:
    """True when ``cache`` is an int8 (values, scales) pair."""
    return isinstance(cache, tuple)


def init_cache(
    cfg: ModelConfig,
    num_blocks: int,
    block_size: int,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
):
    """Zeroed paged KV cache: (k_cache, v_cache). int8 gives (values,
    scales) pairs with per-(slot, head) f32 scales initialized to 1."""
    shape = cache_shape(cfg, num_blocks, block_size)
    k = torch.zeros(shape, dtype=dtype, device=device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    if dtype != torch.int8:
        return k, v
    sshape = kv_scale_shape(
        cfg.num_hidden_layers, num_blocks, block_size, cfg.num_key_value_heads
    )
    ks = torch.ones(sshape, dtype=torch.float32, device=device)
    vs = torch.ones(sshape, dtype=torch.float32, device=device)
    return (k, ks), (v, vs)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float, bias_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32. ``bias_one``: weights stored as (w - 1)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    scale = (1.0 + w) if bias_one else w
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def mlp_act(cfg: ModelConfig, g: torch.Tensor) -> torch.Tensor:
    """Gate activation: silu (llama family) or tanh-gelu (gemma)."""
    if cfg.hidden_act not in ("silu", "gelu"):
        raise ValueError(f"unsupported hidden_act {cfg.hidden_act!r}")
    return act_fn(cfg.hidden_act, g)


def scale_embed(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Gemma-family sqrt(hidden) embedding scaling (no-op otherwise)."""
    if not cfg.scale_embeddings:
        return x
    return (x.float() * math.sqrt(cfg.hidden_size)).to(x.dtype)


def mm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """x @ p[name]; int8 weights go through the K1 kernel wrapper
    (dequant scale on the f32 product, rounded to x's dtype)."""
    w = p[name]
    if w.dtype == torch.int8:
        return qmm(x, w, p[name + "_scale"])
    return x @ w


def embed_lookup(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding rows, rescaled per row when the table is int8."""
    w = p["embed"]
    idx = tokens.long()
    x = w[idx]
    if w.dtype == torch.int8:
        s = p["embed_scale"][idx]
        x = x.to(torch.bfloat16) * s[..., None].to(torch.bfloat16)
    return x


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embeddings in f32 angles; q/k: [B, T, H, Dh], positions [B, T]."""
    half = q.shape[-1] // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=q.device) / half
    # the base made on the device (no host copy: a decode step is
    # captured as a CUDA graph)
    freqs = 1.0 / (torch.full((), theta, dtype=torch.float32, device=q.device) ** exponent)
    angles = positions[..., None].float() * freqs  # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x[..., :half].float(), x[..., half:].float()
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

    return rot(q), rot(k)


def paged_attention_reference(
    q: torch.Tensor,  # [B, T, H, Dh]
    k_cache_l, v_cache_l,  # [n_slots, Hkv, Dh] (one layer), or int8 pairs
    block_tables: torch.Tensor,  # [B, max_blocks]
    positions: torch.Tensor,  # [B, T]
    context_lens: torch.Tensor,  # [B]
    block_size: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Gather-then-attend paged attention (the reference's XLA path):
    dequantize the gathered pages, then ``_reference_attend``."""
    B = q.shape[0]
    S = block_tables.shape[1] * block_size
    slot_ids = (
        block_tables.long()[:, :, None] * block_size
        + torch.arange(block_size, device=q.device)[None, None, :]
    ).reshape(B, S)
    if kv_cache_is_quantized(k_cache_l):
        (kv_l, ks_l), (vv_l, vs_l) = k_cache_l, v_cache_l
        Hk = kv_l.shape[-2]
        ksc = gather_slot_scales(ks_l, slot_ids, block_size, Hk)
        vsc = gather_slot_scales(vs_l, slot_ids, block_size, Hk)
        keys = (kv_l[slot_ids].float() * ksc[..., None]).to(q.dtype)
        vals = (vv_l[slot_ids].float() * vsc[..., None]).to(q.dtype)
    else:
        keys = k_cache_l[slot_ids].to(q.dtype)
        vals = v_cache_l[slot_ids].to(q.dtype)
    return _reference_attend(q, keys, vals, positions, context_lens, sliding_window)


def _reference_attend(q, keys, vals, positions, context_lens, sliding_window):
    """Masked grouped attention: f32 scores, masks at -1e30, softmax in
    f32, probabilities rounded to q's dtype before the value product."""
    B, T, H, Dh = q.shape
    Hk, S = keys.shape[-2], keys.shape[1]
    qg = q.reshape(B, T, Hk, H // Hk, Dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), keys.float()) * (1.0 / math.sqrt(Dh))
    key_pos = torch.arange(S, device=q.device)[None, None, None, None, :]
    pos_q = positions.long()[:, None, None, :, None]
    mask = (key_pos <= pos_q) & (key_pos < context_lens.long()[:, None, None, None, None])
    if sliding_window is not None:
        mask = mask & (key_pos > pos_q - sliding_window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.float(), vals.float()).to(q.dtype)
    return out.reshape(B, T, H, Dh)


# ---------------------------------------------------------------------------
# The forward step
# ---------------------------------------------------------------------------


def fused_mlp_ok(cfg: ModelConfig, lp: Params) -> bool:
    """The fused K1 epilogues serve this layer: dense MLP with every
    post-attention weight int8 and a kernel-supported activation."""
    return (
        not cfg.is_moe
        and cfg.hidden_act in ("silu", "gelu")
        and all(n in lp and lp[n].dtype == torch.int8
                for n in ("wo", "w_gate", "w_up", "w_down"))
    )


def post_attn_mlp(cfg: ModelConfig, lp: Params, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Output projection + MLP residual. ``a`` is the flattened attention
    output [B, T, H*Dh]. With int8 weights: wo with the residual add in
    its epilogue, one gate/up pass with act * up in-kernel, and w_down
    with the second residual add — the rounding points of the composed
    branch below."""
    if fused_mlp_ok(cfg, lp):
        x = qmm(a, lp["wo"], lp["wo_scale"], residual=x)
        h = rmsnorm(x, lp["mlp_norm"], cfg.rms_norm_eps, cfg.norm_bias_one)
        hh = qmm_gate_up(
            h, lp["w_gate"], lp["w_gate_scale"], lp["w_up"], lp["w_up_scale"],
            act=cfg.hidden_act,
        )
        return qmm(hh, lp["w_down"], lp["w_down_scale"], residual=x)
    x = x + mm(lp, "wo", a).to(x.dtype)
    h = rmsnorm(x, lp["mlp_norm"], cfg.rms_norm_eps, cfg.norm_bias_one)
    mlp_out = mm(lp, "w_down", mlp_act(cfg, mm(lp, "w_gate", h)) * mm(lp, "w_up", h))
    return x + mlp_out.to(x.dtype)


_GLOBAL_PARAMS = ("embed", "final_norm", "lm_head", "embed_scale", "lm_head_scale")


def layer_param_names(params: Params) -> list[str]:
    return [k for k in params if k not in _GLOBAL_PARAMS]


def _write_kv(cache, new: torch.Tensor, layer: int, slot_mapping: torch.Tensor, block_size: int):
    """Scatter this layer's fresh K or V rows [B*T, Hk, Dh] into the cache
    at ``slot_mapping``, in place; int8 caches quantize per (token, head)
    and scatter the scales alongside. Padded rows all write slot 0 of the
    garbage block 0, where racing writes are harmless."""
    slots = slot_mapping.long()
    if not kv_cache_is_quantized(cache):
        cache[layer, slots] = new.to(cache.dtype)
        return
    vals, scales = cache
    q8, sc = quantize_kv(new)
    vals[layer, slots] = q8
    pages, offs = scale_scatter_indices(slots, block_size)
    scales[layer, pages, :, offs] = sc


def forward(
    cfg: ModelConfig,
    params: Params,
    k_cache,  # [L, n_slots, Hkv, Dh], or an int8 (values, scales) pair
    v_cache,
    tokens: torch.Tensor,  # [B, T] int32 (padded)
    positions: torch.Tensor,  # [B, T] int32 absolute positions (padded: 0)
    slot_mapping: torch.Tensor,  # [B*T] int32 flat cache slots (padded: slot 0)
    block_tables: torch.Tensor,  # [B, max_blocks] int32 (padded: block 0)
    context_lens: torch.Tensor,  # [B] int32 valid tokens incl. new ones
    last_token_idx: torch.Tensor,  # [B] int32 index of last real token in T
    block_size: int,
    extra_embeds: Optional[torch.Tensor] = None,  # [B, T, D] injected embeds
    embeds_mask: Optional[torch.Tensor] = None,  # [B, T] bool: use injected
    logits_all: bool = False,
):
    """One model step. Returns (logits [B, V] f32, k_cache, v_cache); the
    caches are updated in place and returned for signature parity with
    the reference. ``logits_all`` returns [B, T, V] logits at every fed
    position. Prefill rows are contiguous token runs: the prefill kernel
    places q[b, t] at positions[b, 0] + t."""
    if cfg.is_moe:
        raise NotImplementedError("MoE models are not ported yet")
    H, Hk, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    B, T = tokens.shape
    x = scale_embed(cfg, embed_lookup(params, tokens))  # [B, T, D]
    if extra_embeds is not None:
        if embeds_mask is None:
            raise ValueError("extra_embeds needs embeds_mask")
        x = torch.where(embeds_mask[..., None], extra_embeds.to(x.dtype), x)

    quantized = kv_cache_is_quantized(k_cache)
    kc, ks = k_cache if quantized else (k_cache, None)
    vc, vs = v_cache if quantized else (v_cache, None)
    starts = positions[:, 0].contiguous()
    names = layer_param_names(params)
    for i in range(cfg.num_hidden_layers):
        lp = {n: params[n][i] for n in names}
        h = rmsnorm(x, lp["attn_norm"], cfg.rms_norm_eps, cfg.norm_bias_one)
        q, k, v = mm(lp, "wq", h), mm(lp, "wk", h), mm(lp, "wv", h)
        if cfg.attention_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = q.reshape(B, T, H, Dh)
        k = k.reshape(B, T, Hk, Dh)
        v = v.reshape(B, T, Hk, Dh)
        q, k = rope(q, k, positions, cfg.rope_theta)
        _write_kv(k_cache, k.reshape(B * T, Hk, Dh), i, slot_mapping, block_size)
        _write_kv(v_cache, v.reshape(B * T, Hk, Dh), i, slot_mapping, block_size)
        if T == 1:
            attn = paged_attention_decode_stacked(
                q[:, 0].contiguous(), kc, vc, i, block_tables, context_lens,
                block_size, cfg.sliding_window, ks, vs,
            )[:, None]
        else:
            attn = paged_attention_prefill_stacked(
                q.contiguous(), kc, vc, i, block_tables, starts, context_lens,
                block_size, cfg.sliding_window, ks, vs,
            )
        x = post_attn_mlp(cfg, lp, x, attn.reshape(B, T, H * Dh))

    x = rmsnorm(x, params["final_norm"], cfg.rms_norm_eps, cfg.norm_bias_one)
    if logits_all:
        return lm_head(params, x), k_cache, v_cache
    x_last = x[torch.arange(B, device=x.device), last_token_idx.long()]  # [B, D]
    return lm_head(params, x_last), k_cache, v_cache


def lm_head(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Final hidden -> f32 logits, rounded through the activation dtype."""
    w = p["lm_head"]
    if w.dtype == torch.int8:
        return qmm_lm_head(x, w, p["lm_head_scale"]).float()
    return mm(p, "lm_head", x).float()
