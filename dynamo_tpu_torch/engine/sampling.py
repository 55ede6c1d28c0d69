"""Batched sampling on the device, capturable in a CUDA graph.

The port of the reference's ``sample``: greedy; temperature sampling by
the gumbel-max trick over the full vocabulary (exact, no sort); and
top-k / top-p / min-p shaping on the top-128 slice of the scaled logits,
normalized against the full vocabulary. Returns the chosen tokens and
their log-probabilities under the unscaled distribution.

``sample`` reads no host value: its arrays are device tensors
(``sampling_tensors``), and the reference's runtime branches
(``lax.cond`` on "all rows greedy" and "any row filters") become one
host-known flag, ``sampled``, that picks a variant. The greedy variant
is argmax and log-softmax alone; the sampled variant always computes the
free and the filtered draw and selects per row, as the reference's
``jnp.where`` does, so one captured graph serves every mix of options.

The gumbel noise is a counter-based function of (row seed, vocabulary
index) in torch integer ops (``gumbel_noise``), the counterpart of the
reference's ``jax.random.key(seed)`` per row: the same seed gives the
same row on the same device, whatever the batch, the step's shape or the
pipeline's timing. The reference draws other bits, so the two engines
agree in distribution, not token for token.

Not ported yet: logit bias, penalties, the guided allow-mask and
top-logprobs (the engine rejects requests that ask for them).
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.protocols.common import SamplingOptions

NEG_INF = -1e30
TOP_KF = 128
# the arrays of batch_arrays and their device dtypes
SAMPLING_DTYPES = {
    "temperature": torch.float32,
    "top_k": torch.int32,
    "top_p": torch.float32,
    "min_p": torch.float32,
    "seeds": torch.int64,
}

_M32 = 0xFFFF_FFFF


def batch_arrays(opts: list[SamplingOptions], step_seeds: list[int]) -> dict[str, np.ndarray]:
    """Per-slot sampling params as numpy arrays: temperature (0 = greedy),
    top_k (0 = off), top_p (1 = off), min_p (0 = off), seeds."""
    n = len(opts)
    a = {
        "temperature": np.zeros((n,), np.float32),
        "top_k": np.zeros((n,), np.int32),
        "top_p": np.ones((n,), np.float32),
        "min_p": np.zeros((n,), np.float32),
        "seeds": np.asarray(step_seeds, np.int64),
    }
    for i, o in enumerate(opts):
        if not o.use_greedy and o.temperature is not None:
            a["temperature"][i] = max(o.temperature, 1e-4)
        elif not o.use_greedy:
            a["temperature"][i] = 1.0
        if o.top_k:
            a["top_k"][i] = o.top_k
        if o.top_p is not None:
            a["top_p"][i] = o.top_p
        if o.min_p:
            a["min_p"][i] = o.min_p
    return a


def any_sampled(arrays: dict[str, np.ndarray]) -> bool:
    """The host-known variant flag: does any row sample (temperature > 0)?"""
    return bool((np.asarray(arrays["temperature"]) > 0.0).any())


def sampling_tensors(arrays: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """``batch_arrays`` output as device tensors (one upload each; the
    engine's decode steps stage theirs in one packed copy instead)."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(device=device, dtype=dt)
        for k, dt in SAMPLING_DTYPES.items()
    }


def filter_keep_mask(
    vals: torch.Tensor,  # [..., KF] descending top-KF slice of scaled logits
    lse: torch.Tensor,  # [..., 1] full-vocab logsumexp of the scaled logits
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    min_p: torch.Tensor,
    vocab: int,
) -> torch.Tensor:
    """Boolean keep mask for top-k/top-p/min-p over a descending top-KF
    slice; probabilities are normalized against the full vocabulary."""
    KF = vals.shape[-1]
    ranks = torch.arange(KF, dtype=torch.int32, device=vals.device)
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, vocab))[..., None]
    k_mask = ranks < k
    sprobs = torch.exp(vals - lse)
    cum = torch.cumsum(sprobs, dim=-1)
    p_mask = (cum - sprobs) < top_p[..., None]
    m_mask = sprobs >= (min_p[..., None] * sprobs[..., :1])
    return k_mask & p_mask & m_mask


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64: c is split in
    16-bit halves, so every product stays below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash (xor-shift-multiply, "lowbias32")
    on int64 holding [0, 2^32). torch's ``>>`` on int64 is arithmetic, so
    each shift is masked to its logical width."""
    x = x ^ ((x >> 16) & 0xFFFF)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ ((x >> 15) & 0x1FFFF)
    x = _mul32(x, 0x846CA68B)
    return x ^ ((x >> 16) & 0xFFFF)


def gumbel_noise(seeds: torch.Tensor, V: int) -> torch.Tensor:
    """[B, V] standard gumbel noise on ``seeds``' device, row i a function
    of (seeds[i], vocabulary index) alone. The seed's two 32-bit halves
    hash into a row key; each index is hashed, xored with the key and
    hashed again; the top 24 bits give u in (0, 1) and -log(-log u) the
    noise (|g| < 17.4)."""
    s = seeds.to(torch.int64)
    lo = s & _M32
    hi = (s >> 32) & _M32
    key = _mix32(lo ^ _mix32(hi ^ 0x9E3779B9))[:, None]  # [B, 1]
    idx = _mix32(torch.arange(V, dtype=torch.int64, device=seeds.device))[None, :]
    h = _mix32(idx ^ key)
    u = (((h >> 8) & 0xFFFFFF).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _sampled_tokens(logits: torch.Tensor, s: dict, greedy_tok: torch.Tensor) -> torch.Tensor:
    """The reference's ``sampled_path`` with its ``lax.cond`` on "any row
    filters" resolved to always filtering and selecting per row."""
    V = logits.shape[-1]
    temperature, top_k, top_p, min_p = s["temperature"], s["top_k"], s["top_p"], s["min_p"]
    scaled = logits / temperature.clamp_min(1e-4)[:, None]
    gumbel = gumbel_noise(s["seeds"], V)
    free_tok = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    KF = min(TOP_KF, V)
    vals, idx = torch.topk(scaled, KF, dim=-1)  # descending
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    keep = filter_keep_mask(vals, lse, top_k, top_p, min_p, V)
    fvals = torch.where(keep, vals, torch.full_like(vals, NEG_INF))
    choice = torch.argmax(fvals + torch.gather(gumbel, -1, idx), dim=-1)
    filtered = torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)
    need_filter = (top_k > 0) | (top_p < 1.0) | (min_p > 0.0)
    sampled_tok = torch.where(need_filter, filtered, free_tok)
    return torch.where(temperature <= 0.0, greedy_tok, sampled_tok)


def sample(
    logits: torch.Tensor, s: dict[str, torch.Tensor], sampled: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [B, V] f32 + sampling tensors (``sampling_tensors``) on the
    logits' device -> (next_tokens [B] int32, logprobs of the chosen
    tokens [B] f32). ``sampled=False`` is the all-greedy variant (every
    row's temperature is 0); ``True`` is right for any batch."""
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    next_tok = _sampled_tokens(logits, s, greedy_tok) if sampled else greedy_tok
    logprobs = torch.log_softmax(logits, dim=-1)
    chosen_lp = torch.gather(logprobs, -1, next_tok[:, None].long())[:, 0]
    return next_tok, chosen_lp


def pack_pair(next_tokens: torch.Tensor, logprobs: torch.Tensor) -> torch.Tensor:
    """One packed [2B] f32 of a step's outputs for a single device-to-host
    copy (token ids are exact in f32: vocab < 2^24)."""
    return torch.cat([next_tokens.to(torch.float32), logprobs])
