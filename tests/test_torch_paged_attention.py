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


def _caches(rng, n_pages, bs, quantized, hk=HK, dh=DH):
    """(torch caches + scales, jax caches + scales) holding equal values."""
    S = n_pages * bs
    if quantized:
        vals = [rng.integers(-127, 128, (L, S, hk, dh)).astype(np.int8) for _ in range(2)]
        scs = [rng.uniform(0.005, 0.03, (L, n_pages, hk, bs)).astype(np.float32) for _ in range(2)]
        t = [torch.from_numpy(v) for v in vals] + [torch.from_numpy(s) for s in scs]
        j = [jnp.asarray(v) for v in vals] + [jnp.asarray(s) for s in scs]
        return t, j
    vals = [torch.from_numpy(rng.standard_normal((L, S, hk, dh)).astype(np.float32)).to(torch.bfloat16)
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


# (starts, chunk_lens, layout): the first two are the base layout (H=4,
# Hk=2, Dh=16, 8-token pages, T=16); the others are the layouts the card
# kernel is held to (tests/test_torch_cuda.py): Dh=128 with G=4, and G=8,
# at 16-token pages with starts that are not page-aligned
BASE = dict(H=H, Hk=HK, Dh=DH, bs=8, T=16)
PREFILL_CASES = [
    pytest.param([0, 0], [16, 9], BASE, id="starts0-chunk_lens0"),
    pytest.param([16, 5], [16, 11], BASE, id="starts1-chunk_lens1"),
    pytest.param([0, 21], [16, 11], dict(H=8, Hk=2, Dh=128, bs=16, T=16), id="g4-dh128-bs16-unaligned"),
    pytest.param([5, 37], [16, 13], dict(H=8, Hk=1, Dh=64, bs=16, T=16), id="g8-dh64-bs16-unaligned"),
    pytest.param([19, 0], [24, 17], dict(H=16, Hk=2, Dh=128, bs=16, T=24), id="g8-dh128-bs16-unaligned"),
]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("starts,chunk_lens,layout", PREFILL_CASES)
def test_prefill_matches_pallas_and_gather_path(starts, chunk_lens, layout, window, quantized):
    """First chunks and second chunks (start_pos > 0), a ragged row whose
    tail is padding, bf16 and int8 caches, window on and off, at every
    GQA group and head width the card kernel takes."""
    bs, T = layout["bs"], layout["T"]
    rng = np.random.default_rng(sum(starts) + (window or 0) + quantized)
    ctx_lens = [s + c for s, c in zip(starts, chunk_lens)] + [0]  # + a padded row
    n_pages = sum(-(-c // bs) for c in ctx_lens) + 2
    tables = _tables(rng, ctx_lens, bs, n_pages)
    tc, jc = _caches(rng, n_pages, bs, quantized, layout["Hk"], layout["Dh"])
    B = len(ctx_lens)
    qt, qj = _q(rng, (B, T, layout["H"], layout["Dh"]))
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


# K2's launch plan: (B, Hk, W, bs) of the serving path and of edge cases
PLAN_SHAPES = [(64, 8, 256, 16), (8, 8, 512, 16), (32, 8, 16, 16), (1, 1, 1, 16),
               (256, 8, 8, 16), (4, 1, 512, 128), (3, 2, 7, 1), (5, 8, 100, 128), (2, 4, 33, 8)]


@pytest.mark.parametrize("B,Hk,W,bs", PLAN_SHAPES)
def test_decode_plan_cuts_every_key_once(B, Hk, W, bs):
    kps, n = tpa.decode_plan(B, Hk, W, bs)
    keys = W * bs
    assert kps % tpa.DECODE_CHUNK == 0 and 0 < kps <= 512
    # splits [i kps, (i + 1) kps) cover [0, keys), and the last holds a key
    assert n * kps >= keys and (n - 1) * kps < keys
    # a split's keys span at most the table entries a block holds
    assert (kps - 1) // bs + 2 <= tpa._DECODE_TABLE
    assert tpa.decode_plan(B, Hk, W, bs) == (kps, n)


def test_decode_plan_reads_only_host_sizes_and_fills_the_card():
    import inspect

    assert list(inspect.signature(tpa.decode_plan).parameters) == ["B", "Hk", "W", "bs"]
    # B=64 at 4096-key tables and B=8 at 8192: at least two waves of blocks
    for B, W in ((64, 256), (8, 512)):
        kps, n = tpa.decode_plan(B, 8, W, 16)
        assert B * 8 * n >= tpa._DECODE_MIN_BLOCKS >= 2 * tpa.SMS
    # the 32-stream decode batch (ctx ~160, 16-page tables): more than
    # one block per (sequence, KV head)
    kps, n = tpa.decode_plan(32, 8, 16, 16)
    assert -(-160 // kps) > 1


# splits of 8, 24 and 40 keys cut 8- and 16-token pages; the 13-key
# window starts inside a split, and at ctx 47 (split 24) and ctx 90
# (split 24) lies wholly in the sequence's last split
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 13])
@pytest.mark.parametrize("kps", [8, 24, 40])
@pytest.mark.parametrize("bs", [8, 16])
def test_decode_split_plain_matches_pallas_and_gather_path(monkeypatch, bs, kps, window, quantized):
    """The split-and-merge oracle of K2, at split boundaries forced off
    the page grid, against the Pallas kernel (interpreted) and the
    reference's gather path; a ctx = 0 row gives exact zeros."""
    monkeypatch.setattr(tpa, "decode_plan", lambda B, Hk, W, bs_: (kps, -(-W * bs_ // kps)))
    rng = np.random.default_rng(100 * bs + kps + (window or 0) + quantized)
    ctx_lens = [7, 29, 0, 47, 90]
    n_pages = sum(-(-c // bs) for c in ctx_lens) + 2
    tables = _tables(rng, ctx_lens, bs, n_pages)
    assert -(-tables.shape[1] * bs // kps) > 1  # several splits
    tc, jc = _caches(rng, n_pages, bs, quantized)
    qt, qj = _q(rng, (len(ctx_lens), H, DH))
    ctx = np.asarray(ctx_lens, np.int32)
    layer = 1
    got = tpa.decode_split_plain(
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
