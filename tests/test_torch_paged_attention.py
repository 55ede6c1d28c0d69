"""The port's paged attention (dynamo_tpu_torch/ops/paged_attention.py,
plain versions on the CPU) against the reference's Pallas kernels run
interpreted and against its gather-then-attend path
(``models/llama.py::paged_attention_reference``), on the same inputs.

Tolerance: 2^-7 relative (one bf16 ulp of the output) plus 2^-7 x
max|ref| absolute. An output averages over its keys and is smaller than
the values it averages, so the absolute part scales with the reference
rather than being fixed. The port rounds the V-scaled probabilities to
bf16 against the full row max, the Pallas kernels against the running
max and the gather path after normalization: the same values to ~1 bf16
ulp.
Rows without a valid key must be exact zeros on every side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models.llama import paged_attention_reference as j_reference
from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu_torch.models.llama import paged_attention_reference as t_reference
from dynamo_tpu_torch.ops import paged_attention as tpa

H, HK, DH, L = 4, 2, 16, 3
TOL = 2 ** -7  # rtol, and atol as a fraction of max|ref|


def _tables(rng, ctx_lens, bs, n_pages):
    """Scrambled, disjoint page lists (page 0 stays the garbage page)."""
    W = max(1, max(-(-c // bs) for c in ctx_lens))
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = np.zeros((len(ctx_lens), W), np.int32)
    at = 0
    for b, c in enumerate(ctx_lens):
        n = -(-c // bs)
        tables[b, :n] = perm[at:at + n]
        at += n
    return tables


def _caches(rng, n_pages, bs, quantized):
    """(torch caches + scales, jax caches + scales) holding equal values."""
    S = n_pages * bs
    if quantized:
        vals = [rng.integers(-127, 128, (L, S, HK, DH)).astype(np.int8) for _ in range(2)]
        scs = [rng.uniform(0.005, 0.03, (L, n_pages, HK, bs)).astype(np.float32) for _ in range(2)]
        t = [torch.from_numpy(v) for v in vals] + [torch.from_numpy(s) for s in scs]
        j = [jnp.asarray(v) for v in vals] + [jnp.asarray(s) for s in scs]
        return t, j
    vals = [torch.from_numpy(rng.standard_normal((L, S, HK, DH)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2)]
    return vals + [None, None], [jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) for v in vals] + [None, None]


def _q(rng, shape):
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    atol = TOL * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL, atol=atol)


def _layer_pair(jc, layer):
    """One layer of a jax cache for the gather path (int8: a pair)."""
    (k, v, ks, vs) = jc
    if ks is None:
        return k[layer], v[layer]
    return (k[layer], ks[layer]), (v[layer], vs[layer])


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("bs", [8, 16])
def test_decode_matches_pallas_and_gather_path(bs, window, quantized):
    rng = np.random.default_rng(bs + (window or 0) + quantized)
    ctx_lens = [7, 29, 0, 40]  # ragged, a padded row, several pages
    n_pages = sum(-(-c // bs) for c in ctx_lens) + 2
    tables = _tables(rng, ctx_lens, bs, n_pages)
    tc, jc = _caches(rng, n_pages, bs, quantized)
    qt, qj = _q(rng, (len(ctx_lens), H, DH))
    ctx = np.asarray(ctx_lens, np.int32)
    layer = 2  # layer_idx > 0 of the stacked cache
    got = tpa.paged_attention_decode_stacked(
        qt, tc[0], tc[1], layer, torch.from_numpy(tables), torch.from_numpy(ctx), bs,
        window, tc[2], tc[3],
    )
    pallas = jpa.paged_attention_decode_stacked(
        qj, jc[0], jc[1], jnp.int32(layer), jnp.asarray(tables), jnp.asarray(ctx), bs,
        sliding_window=window, interpret=True, k_scale=jc[2], v_scale=jc[3],
    )
    kl, vl = _layer_pair(jc, layer)
    gather = j_reference(
        qj[:, None], kl, vl, jnp.asarray(tables), jnp.asarray(np.maximum(ctx - 1, 0))[:, None],
        jnp.asarray(ctx), bs, window,
    )[:, 0]
    live = ctx > 0
    _close(got, pallas)
    _close(got[torch.from_numpy(live)], np.asarray(gather, np.float32)[live])
    assert (got[torch.from_numpy(~live)] == 0).all()
    # the per-layer API is the stacked kernel over a one-layer view
    one = tpa.paged_attention_decode(
        qt, tc[0][layer], tc[1][layer], torch.from_numpy(tables), torch.from_numpy(ctx), bs,
        window, None if tc[2] is None else tc[2][layer], None if tc[3] is None else tc[3][layer],
    )
    assert torch.equal(one, got)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("starts,chunk_lens", [([0, 0], [16, 9]), ([16, 5], [16, 11])])
def test_prefill_matches_pallas_and_gather_path(starts, chunk_lens, window, quantized):
    """First chunks and second chunks (start_pos > 0), a ragged row whose
    tail is padding, bf16 and int8 caches, window on and off."""
    bs, T = 8, 16
    rng = np.random.default_rng(sum(starts) + (window or 0) + quantized)
    ctx_lens = [s + c for s, c in zip(starts, chunk_lens)] + [0]  # + a padded row
    n_pages = sum(-(-c // bs) for c in ctx_lens) + 2
    tables = _tables(rng, ctx_lens, bs, n_pages)
    tc, jc = _caches(rng, n_pages, bs, quantized)
    B = len(ctx_lens)
    qt, qj = _q(rng, (B, T, H, DH))
    st = np.asarray(starts + [0], np.int32)
    ctx = np.asarray(ctx_lens, np.int32)
    layer = 1
    got = tpa.paged_attention_prefill_stacked(
        qt, tc[0], tc[1], layer, torch.from_numpy(tables), torch.from_numpy(st),
        torch.from_numpy(ctx), bs, window, tc[2], tc[3],
    )
    pallas = jpa.paged_attention_prefill_stacked(
        qj, jc[0], jc[1], jnp.int32(layer), jnp.asarray(tables), jnp.asarray(st),
        jnp.asarray(ctx), bs, sliding_window=window, interpret=True,
        k_scale=jc[2], v_scale=jc[3],
    )
    _close(got, pallas)
    pos = st[:, None] + np.arange(T)[None]
    kl, vl = _layer_pair(jc, layer)
    gather = np.asarray(j_reference(
        qj, kl, vl, jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(ctx), bs, window,
    ), np.float32)
    valid = pos < ctx[:, None]  # real query tokens
    _close(got.float()[torch.from_numpy(valid)], gather[valid])
    # padded query tokens and the padded row: exact zeros
    assert (got[torch.from_numpy(~valid)] == 0).all()


@pytest.mark.parametrize("quantized", [False, True])
def test_port_gather_path_matches_reference_gather_path(quantized):
    """models/llama.py::paged_attention_reference, port vs reference."""
    bs, T = 8, 5
    rng = np.random.default_rng(40 + quantized)
    ctx_lens = [13, 21]
    n_pages = sum(-(-c // bs) for c in ctx_lens) + 1
    tables = _tables(rng, ctx_lens, bs, n_pages)
    tc, jc = _caches(rng, n_pages, bs, quantized)
    qt, qj = _q(rng, (2, T, H, DH))
    ctx = np.asarray(ctx_lens, np.int32)
    pos = (ctx[:, None] - T + np.arange(T)[None]).astype(np.int32)
    layer = 0
    kl_t = tc[0][layer] if not quantized else (tc[0][layer], tc[2][layer])
    vl_t = tc[1][layer] if not quantized else (tc[1][layer], tc[3][layer])
    got = t_reference(qt, kl_t, vl_t, torch.from_numpy(tables), torch.from_numpy(pos),
                      torch.from_numpy(ctx), bs, 9)
    kl, vl = _layer_pair(jc, layer)
    ref = j_reference(qj, kl, vl, jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(ctx), bs, 9)
    _close(got, ref)
