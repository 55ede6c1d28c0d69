"""Batched sampling on the device.

The port of the reference's ``sample``: greedy; temperature sampling by
the gumbel-max trick over the full vocabulary (exact, no sort); and
top-k / top-p / min-p shaping on the top-128 slice of the scaled logits,
normalized against the full vocabulary. Returns the chosen tokens and
their log-probabilities under the unscaled distribution.

The gumbel noise of row ``i`` comes from its own ``torch.Generator``
seeded with ``seeds[i]``, on the logits' device: one seed gives one
stream, so a request's samples are reproducible. The reference draws
from ``jax.random`` keys, a different generator, so the two engines
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


def gumbel_noise(seeds: list[int], V: int, device: torch.device) -> torch.Tensor:
    """[B, V] standard gumbel noise, row i from a generator seeded seeds[i]."""
    rows = []
    tiny = torch.finfo(torch.float32).tiny
    for seed in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF)
        u = torch.rand(V, generator=g, device=device).clamp_min(tiny)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows)


def sample(logits: torch.Tensor, s: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [B, V] f32 + sampling arrays (``batch_arrays``) ->
    (next_tokens [B] int32, logprobs of the chosen tokens [B] f32)."""
    B, V = logits.shape
    dev = logits.device

    def arr(name, dtype):
        return torch.as_tensor(np.asarray(s[name]), dtype=dtype, device=dev)

    temperature = arr("temperature", torch.float32)
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    next_tok = greedy_tok
    is_greedy = np.asarray(s["temperature"]) <= 0.0
    if not is_greedy.all():
        top_k, top_p, min_p = (
            arr("top_k", torch.int32), arr("top_p", torch.float32), arr("min_p", torch.float32)
        )
        temp = temperature.clamp_min(1e-4)[:, None]
        scaled = logits / temp
        # noise only for the sampled rows; greedy rows never read theirs
        seeds = [int(x) for x in np.asarray(s["seeds"])]
        gumbel = torch.zeros((B, V), dtype=torch.float32, device=dev)
        sampled_rows = np.nonzero(~is_greedy)[0]
        gumbel[torch.as_tensor(sampled_rows, device=dev)] = gumbel_noise(
            [seeds[i] for i in sampled_rows], V, dev
        )
        free_tok = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
        need_filter = (top_k > 0) | (top_p < 1.0) | (min_p > 0.0)
        sampled_tok = free_tok
        need = np.asarray(s["top_k"]) > 0
        need |= np.asarray(s["top_p"]) < 1.0
        need |= np.asarray(s["min_p"]) > 0.0
        if (need & ~is_greedy).any():
            KF = min(TOP_KF, V)
            vals, idx = torch.topk(scaled, KF, dim=-1)  # descending
            lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
            keep = filter_keep_mask(vals, lse, top_k, top_p, min_p, V)
            fvals = torch.where(keep, vals, torch.full_like(vals, NEG_INF))
            g = torch.gather(gumbel, -1, idx)
            choice = torch.argmax(fvals + g, dim=-1)
            filtered = torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)
            sampled_tok = torch.where(need_filter, filtered, free_tok)
        next_tok = torch.where(temperature <= 0.0, greedy_tok, sampled_tok)
    logprobs = torch.log_softmax(logits, dim=-1)
    chosen_lp = torch.gather(logprobs, -1, next_tok[:, None].long())[:, 0]
    return next_tok, chosen_lp
