"""The port's default decode path on the CPU: static serving shapes, the
overlapped decode pipeline and its scheduler plan, against the port's
own serial loop and against the JAX package. Mirrors tests/test_overlap.py.

- Overlap on vs off in the port: greedy and seeded sampled tokens are
  bit-identical (the same step over the same values; seeds offset by the
  in-flight lag), and the pipeline really dispatched with a step in flight.
- A cancel that lands while a step is in flight discards that step's
  token, frees every block and leaves the prefix cache clean.
- A tight block pool (preemption through the serial planner) gives the
  roomy pool's greedy tokens.
- ``apply_static_shapes``, ``_decode_batch``, ``_table_width`` and
  ``plan_pipelined_decode`` equal the reference scheduler's (exactly).
- The port's overlapped engine meets the JAX engine (overlap=True) on
  greedy tokens under tests/test_torch_engine.py's criterion: teacher
  forced on the JAX tokens, the streams agree up to the first position
  whose reference top-2 logit gap is at most 0.16 (twice the 0.08 logit
  tolerance of tests/test_torch_llama.py), and nowhere before it differ.

Bursts go through ``submit_many`` so that both engines of a comparison
batch the same requests together, whatever the thread timing.
"""

import asyncio
import time

import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.allocator import BlockAllocator as JAllocator
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.models.quant import init_params_quantized as j_init_q
from dynamo_tpu.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.protocols.common import SamplingOptions as JSampling
from dynamo_tpu.protocols.common import StopConditions as JStop
from dynamo_tpu.tokens import TokenBlockSequence as JTokens
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.allocator import BlockAllocator
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.telemetry.overlap import OverlapTracker
from dynamo_tpu_torch.tokens import TokenBlockSequence

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
BS = 8
GAP_TOL = 0.16
PROMPTS = [list(range(1, 12)), list(range(5, 21)), [7, 7, 3, 9, 1, 2]]


def _weights():
    jp = j_init_q(JModelConfig(**CFG), seed=5)
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")


_PARAMS = {}


def _port_params():
    if "tp" not in _PARAMS:
        _PARAMS["jp"], _PARAMS["tp"] = _weights()
    return _PARAMS["tp"]


def _config(**kw):
    base = dict(device="cpu", kv_cache_dtype="int8", num_blocks=64, block_size=BS,
                prefill_chunk_size=32, max_prefill_tokens=64, max_batch_size=4,
                max_model_len=128)
    base.update(kw)
    return EngineConfig(**base)


async def _launch(**kw):
    return await TorchEngine.launch(_config(**kw), ModelConfig(**CFG), params=_port_params())


def _request(i, prompt, max_tokens, temperature=None, seed=None):
    sampling = (SamplingOptions(use_greedy=True) if temperature is None
                else SamplingOptions(temperature=temperature, seed=seed))
    return PreprocessedRequest(request_id=f"r{i}", token_ids=list(prompt), sampling=sampling,
                               stop=StopConditions(max_tokens=max_tokens, ignore_eos=True))


async def _drain(queue):
    toks, final = [], None
    while True:
        item = await queue.get()
        if item is None:
            return toks, final
        toks += item.token_ids
        if item.finish_reason is not None:
            final = item


async def _burst(engine, reqs):
    """All requests in one submit: admitted by the same plan."""
    queues = engine.submit_many([(r, Context()) for r in reqs])
    return await asyncio.wait_for(asyncio.gather(*[_drain(q) for q in queues]), 120)


async def _decode_all(engine, prompts=PROMPTS, max_tokens=9, temperature=None, seed=7):
    outs = await _burst(engine, [_request(i, p, max_tokens, temperature, seed)
                                 for i, p in enumerate(prompts)])
    return [o[0] for o in outs]


async def _wait_for(pred, timeout=30.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("engine state not reached")
        await asyncio.sleep(0.01)


# ---------------------------------------------------------------------------
# OverlapTracker (fake clock), as tests/test_overlap.py holds the reference's
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_tracker_counts_idle_gap_only_when_queue_empty():
    clk = _Clock()
    tr = OverlapTracker(clock=clk)
    assert tr.note_dispatch() == 0.0
    clk.t = 1.0
    tr.note_complete()
    clk.t = 1.5
    assert tr.note_dispatch() == pytest.approx(0.5)
    clk.t = 1.6
    assert tr.note_dispatch() == 0.0
    clk.t = 2.0
    tr.note_complete()
    clk.t = 3.0
    assert tr.note_dispatch() == 0.0
    s = tr.stats()
    assert s["steps_dispatched"] == 4 and s["idle_events"] == 1
    assert s["idle_gap_s_total"] == pytest.approx(0.5)
    assert s["max_idle_gap_ms"] == pytest.approx(500.0)


def test_tracker_all_prior_retirement_and_idle_reset():
    clk = _Clock()
    tr = OverlapTracker(clock=clk)
    tr.note_dispatch()
    tr.note_dispatch()
    clk.t = 1.0
    tr.note_complete(all_prior=True)
    assert tr.inflight == 0
    tr.note_idle()
    clk.t = 10.0
    assert tr.note_dispatch() == 0.0
    tr.note_dispatch()
    tr.reset()
    assert tr.inflight == 0


# ---------------------------------------------------------------------------
# The port's engine: overlap on vs off
# ---------------------------------------------------------------------------


async def test_overlap_greedy_and_seeded_bit_identical_vs_serial():
    results = {}
    for overlap in (True, False):
        eng = await _launch(overlap=overlap)
        try:
            results[overlap] = (await _decode_all(eng),
                                await _decode_all(eng, temperature=0.8))
        finally:
            await eng.shutdown()  # the engine thread has recorded every step
        stamps = eng.step_stamps["decode"]
        tracker = eng.overlap.stats()
        assert tracker["steps_dispatched"] == eng.steps["prefill"] + eng.steps["decode"]
        assert all("sync_ms" in s and "idle_gap_ms" in s and "plan_ms" in s for s in stamps)
        if overlap:
            # steps were dispatched with one still in flight: each such step
            # was harvested at depth 2 and ran under host work
            piped = [s for s in stamps if s.get("pipeline_depth") == 2]
            assert len(piped) >= 10
            assert all("overlap_ms" in s for s in piped)
            assert tracker["idle_events"] < tracker["steps_dispatched"]
        else:
            assert all("pipeline_depth" not in s for s in stamps)
    assert results[True] == results[False]
    greedy, sampled = results[True]
    assert all(len(o) == 9 for o in greedy + sampled)
    assert greedy != sampled


async def test_overlap_late_cancel_discards_inflight_token():
    """A stop that lands while the next step is in flight (as a backend's
    stop string would: one step late) ends the stream at the emitted
    tokens: the in-flight token is never appended or emitted, every block
    returns to the pool, and continuing prompt + output through the warm
    prefix cache equals a fresh engine's continuation."""
    eng = await _launch(overlap=True)
    try:
        free0 = eng.allocator.num_free
        ctx = Context()
        emit = eng._emit_token

        def emit_then_stop(seq, token, logprob):
            emit(seq, token, logprob)
            if seq.request_id == "late" and seq.generated == 2:
                ctx.stop_generating()  # the next step is in flight now

        eng._emit_token = emit_then_stop
        req = _request(0, PROMPTS[0], 64)
        req.request_id = "late"
        got, final = await asyncio.wait_for(_drain(eng.submit(req, ctx)), 60)
        assert final.finish_reason == FinishReason.CANCELLED
        assert got and len(got) == 2 and final.completion_tokens == 2
        assert any(s.get("pipeline_depth") == 2 for s in eng.step_stamps["decode"])
        await _wait_for(lambda: not eng.scheduler.has_work and eng.allocator.num_free == free0)
        eng._emit_token = emit
        (warm,) = await _decode_all(eng, [PROMPTS[0] + got], max_tokens=4)
    finally:
        await eng.shutdown()
    fresh = await _launch(overlap=False)
    try:
        (cold,) = await _decode_all(fresh, [PROMPTS[0] + got], max_tokens=4)
    finally:
        await fresh.shutdown()
    assert warm == cold


async def test_overlap_under_block_pressure_matches_roomy_engine():
    """Block exhaustion mid-pipeline drains it to the serial planner,
    which preempts (recompute); the output equals a roomy engine's. The
    streams run to max_model_len (no max_tokens, so admission reserves no
    growth): 3 x 8 blocks at their ends against 13 usable."""
    prompts = [list(range(1, 14)), list(range(3, 17)), list(range(2, 13))]

    async def run(num_blocks):
        eng = await _launch(overlap=True, num_blocks=num_blocks, max_model_len=64)
        try:
            return await _decode_all(eng, prompts, max_tokens=None), eng.scheduler.preemptions
        finally:
            await eng.shutdown()

    tight, tight_preempt = await run(14)
    roomy, roomy_preempt = await run(64)
    assert roomy_preempt == 0 and tight_preempt > 0
    assert tight == roomy
    assert [len(t) for t in tight] == [64 - len(p) for p in prompts]


async def test_static_shapes_pad_every_decode_step():
    eng = await _launch(max_batch_size=8)
    try:
        sched = eng.scheduler
        assert (sched.decode_batch_small, sched.decode_batch_mid, sched.decode_batch_pad) == (4, None, 8)
        assert sched.table_width_pad == 24  # 128-token cap + 1 in 8-token pages, + 1
        seen = []
        build = sched.build_decode_arrays

        def spy(seqs):
            arrays = build(seqs)
            seen.append(arrays["block_tables"].shape)
            return arrays

        sched.build_decode_arrays = spy
        await _decode_all(eng, PROMPTS + [list(range(30, 60))] * 2, max_tokens=5)
    finally:
        await eng.shutdown()
    assert seen and set(seen) <= {(4, 24), (8, 24)}


def test_cuda_graphs_on_the_cpu_raise():
    with pytest.raises(ValueError, match="cuda_graphs"):
        _config(cuda_graphs=True).resolve_cuda_graphs()
    assert _config().resolve_cuda_graphs() is False
    assert EngineConfig().resolve_cuda_graphs() is True
    assert _config().resolve_prewarm() is False and EngineConfig().resolve_prewarm() is True


# ---------------------------------------------------------------------------
# Against the JAX package: static shapes and the pipelined plan
# ---------------------------------------------------------------------------


def _reference_static_scheduler(monkeypatch, **cfg):
    """The reference engine's own setup code, run by its _initialize (the
    loader stubbed to the tiny config: no weights are needed)."""
    from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
    from dynamo_tpu.engine.engine import JaxEngine
    from dynamo_tpu.models import loader

    monkeypatch.setattr(loader, "resolve_model",
                        lambda *a, model_config=None, **k: (model_config, {}))
    eng = JaxEngine(JEngineConfig(random_weights=True, block_size=BS, **cfg))
    eng.model_config = JModelConfig(**CFG)
    eng._initialize()
    return eng.scheduler


@pytest.mark.parametrize("cfg", [
    dict(max_batch_size=64, num_blocks=64),
    dict(max_batch_size=64, num_blocks=2048, max_model_len=200),
    dict(max_batch_size=8, num_blocks=64),
    dict(max_batch_size=4, num_blocks=40),
    dict(max_batch_size=48, num_blocks=512, decode_batch_mid=20),
    dict(max_batch_size=128, num_blocks=512, decode_batch_mid=0),
    dict(max_batch_size=16, num_blocks=512, decode_batch_mid=16),
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_static_shapes_equal_reference(monkeypatch, cfg):
    ref = _reference_static_scheduler(monkeypatch, **cfg)
    port = tsched.Scheduler(BlockAllocator(cfg["num_blocks"], BS), BS,
                            max_batch_size=cfg["max_batch_size"])
    port.apply_static_shapes(cfg["max_batch_size"],
                             cfg.get("max_model_len") or CFG["max_position_embeddings"],
                             cfg["num_blocks"], decode_batch_mid=cfg.get("decode_batch_mid"))
    for f in ("decode_batch_pad", "decode_batch_small", "decode_batch_mid", "table_width_pad"):
        assert getattr(port, f) == getattr(ref, f), f
    for n in range(1, cfg["max_batch_size"] + 1):
        assert port._decode_batch(n) == ref._decode_batch(n), n
    for m in range(1, 3 * (ref.table_width_pad or 8)):
        assert port._table_width(m) == ref._table_width(m), m


def _twin_schedulers(max_tokens, static=False):
    """The reference's and the port's schedulers in the same state: the
    same requests admitted, prefilled and decoded three tokens."""
    out = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            S, A, Seq, Req, Samp, Stop, Toks = (jsched.Scheduler, JAllocator, jsched.Sequence,
                                                JRequest, JSampling, JStop, JTokens)
        else:
            S, A, Seq, Req, Samp, Stop, Toks = (tsched.Scheduler, BlockAllocator, tsched.Sequence,
                                                PreprocessedRequest, SamplingOptions,
                                                StopConditions, TokenBlockSequence)
        sched = S(A(64, BS), BS, max_batch_size=8, prefill_chunk_size=64,
                  max_model_len=96, max_prefill_tokens=256)
        if static:
            for f, v in dict(decode_batch_pad=8, decode_batch_small=4,
                             table_width_pad=16).items():
                setattr(sched, f, v)
        for i, (n, mt) in enumerate(zip((11, 17, 9, 30), max_tokens)):
            req = Req(request_id=f"q{i}", token_ids=list(range(2 + i, 2 + i + n)),
                      sampling=Samp(use_greedy=True), stop=Stop(max_tokens=mt))
            sched.add_request(Seq(request=req, tokens=Toks(req.token_ids, BS)))
        decoded = 0
        while decoded < 3:
            plan = sched.plan()
            if plan.kind == "prefill":
                for w in plan.prefill_batch:
                    sched.complete_prefill_chunk(w)
                    if w.is_last_chunk:
                        sched.append_token(w.seq, 100 + w.seq.arrival)
                continue
            assert plan.kind == "decode" and len(plan.decode_seqs) == 4
            for s in plan.decode_seqs:
                sched.append_token(s, 7 * decoded + s.arrival)
            decoded += 1
        out.append((sched, sorted(sched.running, key=lambda s: s.arrival)))
    return out


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("lags", [(0, 0, 0, 0), (1, 1, 1, 1), (1, 0, 1, 0)])
def test_plan_pipelined_decode_equals_reference(static, lags):
    # q1 finishes inside a lag of 1 (4 of 5 generated); the others run on
    (ref, rseqs), (port, pseqs) = _twin_schedulers((50, 5, 50, 50), static)
    rlag = {id(s): g for s, g in zip(rseqs, lags) if g}
    plag = {id(s): g for s, g in zip(pseqs, lags) if g}
    r = ref.plan_pipelined_decode(rseqs, rlag)
    p = port.plan_pipelined_decode(pseqs, plag)
    assert r is not None and p is not None
    assert [s.request_id for s in p["seqs"]] == [s.request_id for s in r["seqs"]]
    if lags[1]:
        assert "q1" not in [s.request_id for s in p["seqs"]]
    for k in ("tokens", "positions", "slot_mapping", "block_tables", "context_lens",
              "last_token_idx"):
        np.testing.assert_array_equal(p["arrays"][k], r["arrays"][k], err_msg=k)
    np.testing.assert_array_equal(p["src_idx"], r["src_idx"])
    assert p["offsets"] == r["offsets"]
    assert sorted(p["vmap"].values()) == sorted(r["vmap"].values())
    assert [s.block_table for s in pseqs] == [s.block_table for s in rseqs]


@pytest.mark.parametrize("case", ["blocks", "cancelled", "all_finish"])
def test_plan_pipelined_decode_flushes_like_reference(case):
    max_tokens = (4, 4, 4, 4) if case == "all_finish" else (50, 50, 50, 50)
    (ref, rseqs), (port, pseqs) = _twin_schedulers(max_tokens)
    lag = 1
    if case == "cancelled":
        rseqs[2].is_cancelled = pseqs[2].is_cancelled = lambda: True
    if case == "blocks":
        # one free block for four sequences that each need one more
        lag = BS
        for sched in (ref, port):
            while sched.allocator.num_free > 1:
                sched.allocator.allocate_block()
    free = (ref.allocator.num_free, port.allocator.num_free)
    r = ref.plan_pipelined_decode(rseqs, {id(s): lag for s in rseqs})
    p = port.plan_pipelined_decode(pseqs, {id(s): lag for s in pseqs})
    assert r is None and p is None
    # a failed plan rolls its block growth back
    assert (ref.allocator.num_free, port.allocator.num_free) == free
    assert [s.block_table for s in pseqs] == [s.block_table for s in rseqs]


# ---------------------------------------------------------------------------
# Against the JAX engine, overlap on in both
# ---------------------------------------------------------------------------


def _reference_gaps(jp, prompt, toks):
    """Teacher-forced top-2 logit gaps of the reference forward at each
    position that chose ``toks``, and its greedy choices there."""
    jc = JModelConfig(**CFG)
    seq = np.asarray(prompt + toks[:-1], np.int32)[None]
    T = seq.shape[1]
    nb = -(-T // BS) + 1
    k, v = jl.init_cache(jc, nb, BS, dtype=jnp.int8)
    pos = np.arange(T, dtype=np.int32)[None]
    logits, _, _ = jl.forward(jc, jp, k, v, jnp.asarray(seq), jnp.asarray(pos),
                              jnp.asarray((pos[0] + BS).astype(np.int32)),
                              jnp.asarray(np.arange(1, nb, dtype=np.int32)[None]),
                              jnp.asarray([T], np.int32), jnp.asarray([T - 1], np.int32),
                              BS, logits_all=True)
    lg = np.asarray(logits[0])[len(prompt) - 1:]
    top2 = np.sort(lg, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0], lg.argmax(-1)


async def test_overlapped_engine_matches_jax_engine():
    from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
    from dynamo_tpu.engine.engine import JaxEngine
    from dynamo_tpu.runtime.engine import Context as JContext

    jp, tp = _weights()
    jeng = await JaxEngine.launch(JEngineConfig(
        random_weights=True, num_blocks=64, block_size=BS, max_batch_size=4,
        prefill_chunk_size=32, max_model_len=128, kv_cache_dtype="int8",
        quantization="int8", overlap=True), JModelConfig(**CFG))
    try:
        jeng.params = jp  # the weights both engines serve

        async def jgen(i, p):
            req = JRequest(request_id=f"j{i}", token_ids=p, sampling=JSampling(use_greedy=True),
                           stop=JStop(max_tokens=12, ignore_eos=True))
            return [t async for o in jeng.as_async_engine().generate(req, JContext())
                    for t in o.token_ids]

        ref = await asyncio.gather(*[jgen(i, p) for i, p in enumerate(PROMPTS)])
    finally:
        await jeng.shutdown()
    eng = await _launch(overlap=True)
    try:
        got = await _decode_all(eng, max_tokens=12)
        assert any(s.get("pipeline_depth") == 2 for s in eng.step_stamps["decode"])
    finally:
        await eng.shutdown()
    compared = 0
    for prompt, r, g in zip(PROMPTS, ref, got):
        assert len(r) == len(g) == 12
        gaps, choice = _reference_gaps(jp, prompt, r)
        # the JAX engine decoded greedily (up to near-ties)
        assert ((choice == np.asarray(r)) | (gaps <= GAP_TOL)).all()
        for i in range(12):
            if g[i] != r[i]:
                assert gaps[i] <= GAP_TOL, (prompt, i, gaps[i])
                break
            compared += 1
    assert compared >= 24
