"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where no GPU is present (here: decided
inside the fixture, never at import). On a machine with one, without
JAX installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Shapes are small and ragged, to reach the kernels' edge handling that the
serving shapes never do: M, N and K not multiples of the tiles, both K1
configurations and its cluster split-K, every GQA group size, both head
widths, both page sizes.

The engine's decode graphs (``engine/graphs.py``) are held to the eager
step bit for bit: a replay runs the same kernels on the same static
buffers, so any difference is a capture fault, not rounding.

Tolerances: K1 within 2^-7 relative (about one bf16 ulp) plus 2^-9 x
max|ref| (2^-6 relative for gate_up: its activation is rounded twice;
for the residual add, relative to |r| + |x @ W * s|, the magnitude of
the operands it rounds);
attention within 2^-7 relative (one bf16 ulp of the output) plus 2^-7 x
max|ref| absolute, the maximum taken per sequence: an output averages
over up to hundreds of keys, so it is far smaller than the values it
averages, and a fixed absolute limit would hide a mis-weighted key.
"""

import asyncio
import math

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops import qmatmul as qm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _close(got, ref, rtol, atol_frac=2 ** -9, mag=None):
    """|got - ref| <= atol + rtol * mag (mag: |ref|, or for a sum the
    magnitude of its operands)."""
    torch.cuda.synchronize()
    atol = atol_frac * ref.float().abs().max().item()
    assert torch.isfinite(got.float()).all()
    mag = ref.float().abs() if mag is None else mag
    excess = (got.float() - ref.float()).abs() - (atol + rtol * mag)
    assert excess.max().item() <= 0, excess.max().item()


def _qmm_operands(gen, M, K, N):
    x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda", generator=gen)
    w2 = torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda", generator=gen)
    s = torch.rand(N, device="cuda", generator=gen) / (64 * math.sqrt(K)) + 1e-5
    s2 = torch.rand(N, device="cuda", generator=gen) / (64 * math.sqrt(K)) + 1e-5
    r = torch.randn(M, N, device="cuda", generator=gen).to(torch.bfloat16)
    return x, w, w2, s, s2, r


# ragged M, N and K; M = 64 and 65 on either side of the decode/prefill
# threshold; (64, 4096, 1024) splits K over a cluster of 16; (200, 512,
# 392) is a prefill tile with a ragged N tail
@pytest.mark.parametrize("M,K,N", [(1, 64, 64), (5, 200, 100), (13, 4096, 1024),
                                   (70, 640, 4096), (129, 1536, 192), (64, 4096, 1024),
                                   (64, 1024, 4096), (65, 1024, 4096), (200, 512, 392)])
@pytest.mark.parametrize("variant", ["plain", "residual", "gate_up_silu", "gate_up_gelu", "lm_head"])
def test_qmm_kernel_matches_plain(gen, M, K, N, variant):
    x, w, w2, s, s2, r = _qmm_operands(gen, M, K, N)
    if variant == "plain":
        got, ref = qm.qmm(x, w, s), qm.qmm_plain(x, w, s)
    elif variant == "residual":
        got, ref = qm.qmm(x, w, s, residual=r), qm.qmm_plain(x, w, s, r)
        _close(got, ref, rtol=2 ** -7, mag=r.float().abs() + qm.qmm_plain(x, w, s).float().abs())
        return
    elif variant == "lm_head":
        got, ref = qm.qmm_lm_head(x, w, s), qm.qmm_plain(x, w, s)
    else:
        act = variant.split("_")[-1]
        got = qm.qmm_gate_up(x, w, s, w2, s2, act=act)
        ref = qm.qmm_gate_up_plain(x, w, s, w2, s2, act)
        _close(got, ref, rtol=2 ** -6)
        return
    _close(got, ref, rtol=2 ** -7)


@pytest.mark.parametrize("variant", ["plain", "residual", "gate_up"])
def test_qmm_split_k_is_deterministic(gen, variant):
    """A cluster sums its partial tiles in rank order: two launches agree
    bit for bit."""
    M, K, N = 64, 4096, 1024
    assert qm.launch_plan(M, N, K, variant if variant != "plain" else "").splits > 1
    x, w, w2, s, s2, r = _qmm_operands(gen, M, K, N)
    if variant == "gate_up":
        run = lambda: qm.qmm_gate_up(x, w, s, w2, s2)  # noqa: E731
    else:
        run = lambda: qm.qmm(x, w, s, residual=r if variant == "residual" else None)  # noqa: E731
    a, b = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_qmm_counts_launches_and_checks_operands(gen):
    x = torch.randn(4, 64, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randint(-127, 128, (64, 64), dtype=torch.int8, device="cuda", generator=gen)
    s = torch.rand(64, device="cuda", generator=gen)
    before = qm.qmm.launches
    qm.qmm(x, w, s)
    assert qm.qmm.launches == before + 1
    with pytest.raises(TypeError):
        qm.qmm(x.float(), w, s)  # the kernel takes bf16 activations
    with pytest.raises(ValueError):
        qm.qmm(x, w.cpu(), s)
    assert qm.qmm.launches == before + 1


def _close_per_sequence(got, ref):
    for b in range(ref.shape[0]):
        _close(got[b], ref[b], rtol=2 ** -7, atol_frac=2 ** -7)


def _paged(gen, B, ctx, bs, L, Hk, Dh, quantized):
    W = max(1, max(-(-c // bs) for c in ctx))
    n_pages = sum(-(-c // bs) for c in ctx) + 1
    perm = torch.randperm(n_pages - 1, device="cuda", generator=gen) + 1
    tables = torch.zeros(B, W, dtype=torch.int32, device="cuda")
    at = 0
    for b, c in enumerate(ctx):
        n = -(-c // bs)
        tables[b, :n] = perm[at:at + n].to(torch.int32)
        at += n
    S = n_pages * bs
    if quantized:
        kv = [torch.randint(-127, 128, (L, S, Hk, Dh), dtype=torch.int8, device="cuda", generator=gen)
              for _ in range(2)]
        sc = [torch.rand(L, n_pages, Hk, bs, device="cuda", generator=gen) * 0.02 + 1e-3 for _ in range(2)]
    else:
        kv = [torch.randn(L, S, Hk, Dh, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(2)]
        sc = [None, None]
    return tables, kv, sc


# (contexts, forced keys_per_split): ragged contexts under the default
# plan; long contexts (B <= 4) that the plan cuts into many splits, where
# the 50-key window of ctx 5000 crosses a split edge; and 64-key splits
# forced on the plan, which cut 128-token pages and put the window of
# ctx 300 across the edge at 256. A ctx = 0 row in each.
DECODE_LAYOUTS = {
    "ragged": ([1, 37, 0, 300, 129], None),
    "long": ([5000, 8192, 0, 77], None),
    "split64": ([1, 37, 0, 300, 129, 700], 64),
}


def _force_plan(monkeypatch, kps):
    monkeypatch.setattr(pa, "decode_plan", lambda B, Hk, W, bs: (kps, -(-W * bs // kps)))


@pytest.mark.parametrize("layout", list(DECODE_LAYOUTS))
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("H,Hk", [(8, 8), (8, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 50])
def test_decode_kernel_matches_plain(gen, monkeypatch, Dh, H, Hk, bs, quantized, window, layout):
    ctx_list, kps = DECODE_LAYOUTS[layout]
    if kps:
        _force_plan(monkeypatch, kps)
    B, L, layer = len(ctx_list), 3, 2
    tables, kv, sc = _paged(gen, B, ctx_list, bs, L, Hk, Dh, quantized)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, Dh, device="cuda", generator=gen).to(torch.bfloat16)
    got = pa.paged_attention_decode_stacked(q, kv[0], kv[1], layer, tables, ctx, bs, window, *sc)
    pos = (ctx.long() - 1)[:, None]
    ref = pa.paged_attention_plain(q[:, None], kv[0], kv[1], layer, tables, pos, ctx, bs, window, *sc)[:, 0]
    torch.cuda.synchronize()
    _close_per_sequence(got, ref)
    assert (got[ctx == 0] == 0).all()  # ctx 0: exact zeros


def test_decode_split_merge_is_deterministic(gen):
    """B=64, contexts 128..4096, int8, 16-token pages (the serving shape):
    the splits are merged in order without atomics, so two calls agree
    bit for bit."""
    ctx_list = torch.linspace(128, 4096, 64).int().tolist()
    tables, kv, sc = _paged(gen, 64, ctx_list, 16, 1, 8, 128, True)
    assert pa.decode_plan(64, 8, tables.shape[1], 16)[1] > 1
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
    q = torch.randn(64, 32, 128, device="cuda", generator=gen).to(torch.bfloat16)
    a = pa.paged_attention_decode_stacked(q, kv[0], kv[1], 0, tables, ctx, 16, None, *sc)
    b = pa.paged_attention_decode_stacked(q, kv[0], kv[1], 0, tables, ctx, 16, None, *sc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("window", [None, 50])
def test_decode_rows_without_keys_are_zero(gen, monkeypatch, window):
    """ctx = 0 rows write exact zeros with several splits a row, also in
    a launch where no sequence has a key (no split block is live)."""
    _force_plan(monkeypatch, 64)
    ctx_list = [0, 3000, 0]
    tables, kv, sc = _paged(gen, 3, ctx_list, 16, 1, 2, 128, True)
    assert -(-tables.shape[1] * 16 // 64) > 1
    q = torch.randn(3, 8, 128, device="cuda", generator=gen).to(torch.bfloat16)
    for ctx_now in (ctx_list, [0, 0, 0]):
        ctx = torch.tensor(ctx_now, dtype=torch.int32, device="cuda")
        got = pa.paged_attention_decode_stacked(q, kv[0], kv[1], 0, tables, ctx, 16, window, *sc)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        assert (got[ctx == 0] == 0).all()


def _prefill_case(gen, T, chunk, start, bs, H, Hk, Dh, quantized, window):
    """Sequences whose chunks of ``chunk[b]`` real tokens (0: a padded
    row) start at ``start`` in a T-token rectangle, against the plain
    version; returns the kernel's output."""
    L, layer = 2, 1
    B = len(chunk)
    ctx_list = [start + c if c else 0 for c in chunk]
    tables, kv, sc = _paged(gen, B, ctx_list, bs, L, Hk, Dh, quantized)
    starts = torch.tensor([start if c else 0 for c in chunk], dtype=torch.int32, device="cuda")
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
    q = torch.randn(B, T, H, Dh, device="cuda", generator=gen).to(torch.bfloat16)
    got = pa.paged_attention_prefill_stacked(q, kv[0], kv[1], layer, tables, starts, ctx, bs, window, *sc)
    pos = starts.long()[:, None] + torch.arange(T, device="cuda")[None]
    ref = pa.paged_attention_plain(q, kv[0], kv[1], layer, tables, pos, ctx, bs, window, *sc)
    torch.cuda.synchronize()
    _close_per_sequence(got, ref)
    return got


# T = 100 is not a multiple of the query tile at any G; start 70 is not
# page-aligned at either page size; 16-token pages put four pages in a
# 64-key chunk, 128-token pages a chunk inside one page
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("H,Hk", [(8, 8), (8, 2), (32, 8), (8, 1)])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("start", [0, 70])
def test_prefill_kernel_matches_plain(gen, Dh, H, Hk, bs, quantized, window, start):
    got = _prefill_case(gen, 100, [100, 37, 0], start, bs, H, Hk, Dh, quantized, window)
    assert (got[1, 37:] == 0).all() and (got[2] == 0).all()  # padded rows


# a long second chunk: each tile runs up to 28 double-buffered key chunks,
# most of them unmasked, and the block table is far wider than a chunk
@pytest.mark.parametrize("H,Hk", [(32, 8), (8, 1)])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 300])
def test_prefill_kernel_long_context(gen, H, Hk, bs, quantized, window):
    got = _prefill_case(gen, 256, [256, 200, 0], 1536, bs, H, Hk, 128, quantized, window)
    assert (got[1, 200:] == 0).all() and (got[2] == 0).all()  # padded rows


def test_attention_rejects_what_the_kernel_does_not_take(gen):
    tables, kv, sc = _paged(gen, 1, [20], 16, 1, 2, 96, False)
    q = torch.randn(1, 4, 96, device="cuda", generator=gen).to(torch.bfloat16)
    ctx = torch.tensor([20], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention_decode_stacked(q, kv[0], kv[1], 0, tables, ctx, 16)
    with pytest.raises(IndexError):
        tables2, kv2, _ = _paged(gen, 1, [20], 16, 1, 2, 64, False)
        pa.paged_attention_decode_stacked(q[..., :64].contiguous(), kv2[0], kv2[1], 5, tables2, ctx, 16)


# ---------------------------------------------------------------------------
# Decode steps as CUDA graphs (engine/graphs.py) against the eager step
# ---------------------------------------------------------------------------

_TINY = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


async def _launch_tiny(**kw):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.quant import init_params_quantized

    mc = ModelConfig(**_TINY)
    cfg = dict(device="cuda", kv_cache_dtype="int8", num_blocks=64, block_size=16,
               max_batch_size=8, prefill_chunk_size=64, max_prefill_tokens=256)
    cfg.update(kw)
    return await TorchEngine.launch(EngineConfig(**cfg), mc,
                                    params=init_params_quantized(mc, seed=3, device="cuda"))


def _tiny_engine(**kw):
    """An engine for driving its decode graphs directly (no requests: its
    event loop is closed once launched)."""
    return asyncio.run(_launch_tiny(**kw))


def _step_arrays(B, W, first_page, seed):
    """Decode arrays of B live rows (contexts 5..40, pages from
    ``first_page`` on), with greedy and sampled rows."""
    from dynamo_tpu_torch.engine.sampling import batch_arrays
    from dynamo_tpu_torch.protocols.common import SamplingOptions

    rng = np.random.default_rng(seed)
    ctx = rng.integers(5, 40, B).astype(np.int32)
    tables = np.zeros((B, W), np.int32)
    for b in range(B):
        tables[b, :3] = first_page + 3 * b + np.arange(3)
    pos = ctx - 1
    arrays = {
        "tokens": rng.integers(0, _TINY["vocab_size"], (B, 1)).astype(np.int32),
        "positions": pos[:, None].astype(np.int32),
        "slot_mapping": (tables[np.arange(B), pos // 16] * 16 + pos % 16).astype(np.int32),
        "block_tables": tables, "context_lens": ctx,
        "last_token_idx": np.zeros(B, np.int32),
    }
    opts = [SamplingOptions(use_greedy=True), SamplingOptions(temperature=0.8, top_p=0.9),
            SamplingOptions(temperature=1.2), SamplingOptions(temperature=0.7, top_k=5)]
    return arrays, batch_arrays([opts[i % 4] for i in range(B)], list(range(seed, seed + B)))


def _replay_vs_eager(eng, arrays, sampling, sampled):
    B, W = arrays["block_tables"].shape
    inp = eng.decode.prepare(B, W, sampled)
    inp.stage(arrays, sampling)
    packed, toks = eng.decode.run(B, W, sampled)
    got = (packed.clone(), toks.clone())
    want = eng._step_body(inp.views, sampled)  # same inputs, eagerly
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("sampled", [False, True])
def test_captured_decode_step_equals_eager(card, sampled):
    eng = _tiny_engine()
    try:
        sched = eng.scheduler
        assert (sched.decode_batch_small, sched.decode_batch_pad) == (4, 8)
        W = sched.table_width_pad
        assert {k[:2] for k in eng.decode.graphs} == {(4, W), (8, W)}  # prewarmed
        with torch.inference_mode():
            for B in (4, 8):
                arrays, sampling = _step_arrays(B, W, 1, seed=B)
                if not sampled:
                    sampling["temperature"][:] = 0.0
                (gp, gt), (ep, et) = _replay_vs_eager(eng, arrays, sampling, sampled)
                assert torch.equal(gp, ep) and torch.equal(gt, et)
                assert torch.isfinite(gp).all()
                assert ((gt >= 0) & (gt < _TINY["vocab_size"])).all()
    finally:
        asyncio.run(eng.shutdown())


def test_one_graph_replayed_with_different_inputs(card):
    eng = _tiny_engine()
    try:
        W = eng.scheduler.table_width_pad
        with torch.inference_mode():
            a = _step_arrays(8, W, 1, seed=1)
            b = _step_arrays(8, W, 30, seed=2)  # other pages, tokens, seeds
            (ga, _), (ea, _) = _replay_vs_eager(eng, *a, True)
            (gb, _), (eb, _) = _replay_vs_eager(eng, *b, True)
        assert torch.equal(ga, ea) and torch.equal(gb, eb)
        assert not torch.equal(ga, gb)
    finally:
        asyncio.run(eng.shutdown())


def test_replay_adds_the_captured_launch_counts(card):
    from dynamo_tpu_torch.engine.graphs import counted_wrappers

    eng = _tiny_engine()
    try:
        W = eng.scheduler.table_width_pad
        g = eng.decode.graphs[(8, W, True)]
        # 2 layers of q, k, v, o + residual, down + residual (qmm), gate_up
        # and one K2 call; one lm_head; no prefill
        assert g.launches == [10, 2, 1, 2, 0]
        with torch.inference_mode():
            arrays, sampling = _step_arrays(8, W, 1, seed=3)
            inp = eng.decode.prepare(8, W, True)
            inp.stage(arrays, sampling)
            before = [fn.launches for fn in counted_wrappers()]
            eng.decode.run(8, W, True)
            after = [fn.launches for fn in counted_wrappers()]
            assert [x - y for x, y in zip(after, before)] == g.launches
            eng._step_body(inp.views, True)  # eager: the same launches
            eager = [fn.launches for fn in counted_wrappers()]
            assert [x - y for x, y in zip(eager, after)] == g.launches
        torch.cuda.synchronize()
    finally:
        asyncio.run(eng.shutdown())


def test_engine_graphs_and_overlap_match_eager_serial(card):
    """Greedy and seeded tokens through the whole engine: graphs + overlap
    against eager + serial, the same burst admitted together."""
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n).tolist() for n in (5, 40, 17, 70, 33, 9)]

    def run(**kw):
        async def go():
            eng = await _launch_tiny(**kw)
            reqs = [PreprocessedRequest(
                request_id=f"g{i}", token_ids=p,
                sampling=(SamplingOptions(use_greedy=True) if i % 2 else
                          SamplingOptions(temperature=0.9, top_p=0.95, seed=40 + i)),
                stop=StopConditions(max_tokens=20)) for i, p in enumerate(prompts)]
            async def drain(q):
                toks, lps = [], []
                while (item := await q.get()) is not None:
                    toks += item.token_ids
                    lps += item.log_probs or []
                return toks, lps

            try:
                queues = eng.submit_many([(r, Context()) for r in reqs])
                outs = await asyncio.wait_for(asyncio.gather(*[drain(q) for q in queues]), 300)
            finally:
                await eng.shutdown()
            return outs, eng
        return asyncio.run(go())

    graphs, eng_g = run(cuda_graphs=True, overlap=True)
    eager, eng_e = run(cuda_graphs=False, overlap=False)
    assert graphs == eager
    assert all(len(t) == 20 for t, _ in graphs)
    assert eng_g.decode is None and eng_g.use_graphs and not eng_e.use_graphs
    assert any(s.get("pipeline_depth") == 2 for s in eng_g.step_stamps["decode"])


def test_failed_capture_raises(card, monkeypatch):
    """A capture that fails (here: a host sync inside the captured step)
    fails the launch; the engine never falls back to eager steps."""
    from dynamo_tpu_torch.engine.engine import TorchEngine

    body = TorchEngine._step_body

    def syncing_body(self, inp, sampled):
        out = body(self, inp, sampled)
        out[0].sum().item()  # a device-to-host read: not capturable
        return out

    monkeypatch.setattr(TorchEngine, "_step_body", syncing_body)
    with pytest.raises(RuntimeError, match="capture failed"):
        _tiny_engine()
    torch.cuda.synchronize()
