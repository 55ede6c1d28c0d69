"""The port's serving engine (dynamo_tpu_torch/engine/engine.py) on the
CPU: concurrent ``generate`` streams through continuous batching with
chunked prefill, on weights carried across from the reference.

- Greedy streams equal the port's own one-shot ``forward`` roll-out
  exactly (the same code on the same values: no tolerance).
- Teacher-forced, every emitted token's logprob matches the reference
  ``forward``'s within 0.16: twice the 0.08 logit tolerance of
  tests/test_torch_llama.py, since a log-softmax moves by at most the
  largest logit error plus that of its logsumexp.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.models.quant import init_params_quantized as j_init_q
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    GuidedOptions,
    OutputOptions,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime.engine import Context

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
BS = 8
OSL = 6
LP_TOL = 0.16


def _weights():
    jp = j_init_q(JModelConfig(**CFG), seed=5)
    return jp, params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _config(**kw):
    base = dict(device="cpu", kv_cache_dtype="int8", num_blocks=64, block_size=BS,
                prefill_chunk_size=16, max_prefill_tokens=32, max_batch_size=8)
    base.update(kw)
    return EngineConfig(**base)


async def _collect(engine, req, ctx=None):
    toks, lps, finals = [], [], []
    async for out in engine.as_async_engine().generate(req, ctx or Context()):
        toks += out.token_ids
        lps += out.log_probs or []
        if out.finish_reason is not None:
            finals.append(out)
    return toks, lps, finals


def _rollout(mc, params, prompt, n):
    """Greedy roll-out by calling forward directly: one prefill of the
    whole prompt, then one decode step per token."""
    k, v = tl.init_cache(mc, 16, BS, torch.int8, "cpu")
    table = torch.arange(1, 16, dtype=torch.int32)[None]
    P = len(prompt)
    toks = []
    pos = torch.arange(P, dtype=torch.int32)[None]
    feed = torch.tensor([prompt], dtype=torch.int32)
    for step in range(n):
        slots = (table[0, pos[0] // BS] * BS + pos[0] % BS).to(torch.int32)
        ctx = torch.tensor([int(pos[0, -1]) + 1], dtype=torch.int32)
        last = torch.tensor([pos.shape[1] - 1], dtype=torch.int32)
        logits, k, v = tl.forward(mc, params, k, v, feed, pos, slots, table, ctx, last, BS)
        toks.append(int(logits[0].argmax()))
        pos = torch.tensor([[P + step]], dtype=torch.int32)
        feed = torch.tensor([[toks[-1]]], dtype=torch.int32)
    return toks


def _reference_logprobs(jp, prompt, toks):
    """Teacher-forced logprobs of ``toks`` after ``prompt`` from the
    reference forward (logits at every position, one call)."""
    jc = JModelConfig(**CFG)
    seq = np.asarray(prompt + toks[:-1], np.int32)[None]
    T = seq.shape[1]
    nb = -(-T // BS) + 1
    k, v = jl.init_cache(jc, nb, BS, dtype=jnp.int8)
    pos = np.arange(T, dtype=np.int32)[None]
    slots = (pos[0] + BS).astype(np.int32)  # pages 1.. (page 0 is garbage)
    table = np.arange(1, nb, dtype=np.int32)[None]
    logits, _, _ = jl.forward(jc, jp, k, v, jnp.asarray(seq), jnp.asarray(pos),
                              jnp.asarray(slots), jnp.asarray(table),
                              jnp.asarray([T], np.int32), jnp.asarray([T - 1], np.int32),
                              BS, logits_all=True)
    lps = np.asarray(jax.nn.log_softmax(logits[0], axis=-1))
    P = len(prompt)
    return np.array([lps[P - 1 + i, t] for i, t in enumerate(toks)])


async def test_concurrent_streams_chunked_prefill_and_parity():
    jp, tp = _weights()
    mc = ModelConfig(**CFG)
    engine = await TorchEngine.launch(_config(), mc, params=tp)
    rng = np.random.default_rng(3)
    lens = [5, 19, 40, 11]  # 40 > prefill_chunk_size: chunked
    prompts = [rng.integers(0, CFG["vocab_size"], n).tolist() for n in lens]
    samp = [SamplingOptions(use_greedy=True), SamplingOptions(temperature=0.8, seed=3),
            SamplingOptions(use_greedy=True), SamplingOptions(temperature=0.0)]
    reqs = [PreprocessedRequest(request_id=f"r{i}", token_ids=p, sampling=s,
                                stop=StopConditions(max_tokens=OSL))
            for i, (p, s) in enumerate(zip(prompts, samp))]
    try:
        results = await asyncio.wait_for(
            asyncio.gather(*[_collect(engine, r) for r in reqs]), timeout=120)
    finally:
        await engine.shutdown()
    assert engine.steps["prefill"] >= 3  # the long prompt took several chunks
    for i, (toks, lps, finals) in enumerate(results):
        assert len(toks) == OSL and len(lps) == OSL
        assert len(finals) == 1
        assert finals[0].finish_reason == FinishReason.LENGTH
        assert finals[0].completion_tokens == OSL
        assert finals[0].prompt_tokens == lens[i]
        if samp[i].use_greedy or samp[i].temperature == 0.0:
            assert toks == _rollout(mc, tp, prompts[i], OSL), f"request {i}"
        ref = _reference_logprobs(jp, prompts[i], toks)
        np.testing.assert_allclose(np.asarray(lps), ref, rtol=0, atol=LP_TOL)


@pytest.mark.parametrize("field", ["logit_bias", "penalty", "guided", "top_logprobs", "mm_embeds"])
async def test_unsupported_features_are_rejected(field):
    _, tp = _weights()
    engine = await TorchEngine.launch(_config(), ModelConfig(**CFG), params=tp)
    kw = {}
    if field == "logit_bias":
        kw["sampling"] = SamplingOptions(logit_bias={3: 2.0})
    elif field == "penalty":
        kw["sampling"] = SamplingOptions(repetition_penalty=1.3)
    elif field == "guided":
        kw["guided"] = GuidedOptions(kind="json_object")
    elif field == "top_logprobs":
        kw["output"] = OutputOptions(logprobs=2)
    else:
        kw["mm_embeds"] = [{"offset": 0}]
    try:
        req = PreprocessedRequest(request_id="x", token_ids=[1, 2, 3], **kw)
        with pytest.raises(ValueError, match="not supported"):
            engine.submit(req, Context())
        with pytest.raises(ValueError, match="out of range"):
            engine.submit(PreprocessedRequest(request_id="y", token_ids=[999]), Context())
    finally:
        await engine.shutdown()


async def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        await TorchEngine.launch(EngineConfig(random_weights=True, num_blocks=8),
                                 ModelConfig(**CFG))
    with pytest.raises(ValueError, match="num_blocks"):
        await TorchEngine.launch(_config(num_blocks=None, random_weights=True),
                                 ModelConfig(**CFG))


async def test_cancel_and_deadline_finish_streams():
    _, tp = _weights()
    engine = await TorchEngine.launch(_config(), ModelConfig(**CFG), params=tp)
    try:
        ctx = Context()
        req = PreprocessedRequest(request_id="c", token_ids=[5, 6, 7],
                                  stop=StopConditions(max_tokens=200))
        toks, final = [], None
        async for out in engine.as_async_engine().generate(req, ctx):
            toks += out.token_ids
            if len(toks) == 2:
                ctx.stop_generating()
            final = out.finish_reason or final
        assert final == FinishReason.CANCELLED and 2 <= len(toks) < 200
        late = Context()
        late.set_deadline_ms(0.0)
        _, _, finals = await _collect(engine, PreprocessedRequest(
            request_id="d", token_ids=[1, 2], stop=StopConditions(max_tokens=5)), late)
        assert finals[0].finish_reason == FinishReason.TIMEOUT
        # blocks of finished streams return to the pool
        assert engine.allocator.num_free == engine.allocator.num_blocks - 1
    finally:
        await engine.shutdown()

