"""The serving engine: continuous batching over the port's model.

``TorchEngine`` has the reference engine's public surface for the serial
path: ``launch(config)``, ``submit``, ``as_async_engine()`` and the
adapter's ``generate`` (a ``PreprocessedRequest`` in, a stream of
``LLMEngineOutput`` out). A dedicated engine thread runs one step at a
time: plan (scheduler), build the step arrays, ``forward``, ``sample``,
emit. No overlap of host and device work, no CUDA graphs, no speculative
decoding, fused windows, KV offload tiers, guided decoding or telemetry
yet.

The engine runs on ``config.device``: "cuda" (the default) launches the
port's CUDA kernels and fails if no GPU is present; "cpu" runs their
plain versions (tests).
"""

from __future__ import annotations

import asyncio
import logging
import queue as thread_queue
import threading
import time
import zlib
from typing import Any, AsyncIterator, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.allocator import BlockAllocator
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.sampling import batch_arrays, sample
from dynamo_tpu_torch.engine.scheduler import Scheduler, SeqState, Sequence
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import init_params, init_params_quantized
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context, EngineStream
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger("dynamo_tpu_torch.engine")

_KV_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}
# device memory kept free beside an auto-sized cache: step activations,
# logits and the sampling noise of a full batch
_HEADROOM_BYTES = 4 << 30


def resolve_device(name: str) -> torch.device:
    """The engine's device; a CUDA device without a GPU is an error, never
    a silent move to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"EngineConfig.device={name!r} but no CUDA device is available "
            "(pass device='cpu' to run the kernels' plain versions)"
        )
    return dev


def cache_block_bytes(mc: ModelConfig, block_size: int, kv_dtype: torch.dtype) -> int:
    """Device bytes of one KV block (K and V, every layer, int8 scales)."""
    elems = mc.num_hidden_layers * block_size * mc.num_key_value_heads * mc.head_dim
    per = 2 * elems * torch.empty((), dtype=kv_dtype).element_size()
    if kv_dtype == torch.int8:
        per += 2 * mc.num_hidden_layers * mc.num_key_value_heads * block_size * 4
    return per


class TorchEngine:
    def __init__(self, config: EngineConfig):
        self.config = config
        self.model_config: Optional[ModelConfig] = None
        self.params: Optional[dict] = None
        self.device: Optional[torch.device] = None
        self.k_cache: Any = None
        self.v_cache: Any = None
        self.allocator: Optional[BlockAllocator] = None
        self.scheduler: Optional[Scheduler] = None
        self.steps = {"prefill": 0, "decode": 0}
        # wall seconds of each step by kind (plan to emit, host clock; the
        # step ends in a host copy of the sampled tokens, so it includes
        # the device time)
        self.step_seconds: dict[str, list[float]] = {"prefill": [], "decode": []}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._incoming: thread_queue.Queue = thread_queue.Queue()
        self._wake = threading.Event()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    @classmethod
    async def launch(
        cls,
        config: EngineConfig,
        model_config: Optional[ModelConfig] = None,
        params: Optional[dict] = None,
    ) -> "TorchEngine":
        """Build the model and cache and start the engine thread.
        ``model_config`` skips reading config.json (synthetic shapes);
        ``params`` supplies weights already on the engine's device (e.g.
        carried across from the reference by ``models/convert.py``)."""
        engine = cls(config)
        engine.model_config = model_config
        loop = asyncio.get_running_loop()
        engine._loop = loop
        await loop.run_in_executor(None, engine._initialize, params)
        engine._running = True
        engine._thread = threading.Thread(
            target=engine._step_loop, name="torch-engine", daemon=True
        )
        engine._thread.start()
        return engine

    def _initialize(self, params: Optional[dict]) -> None:
        cfg = self.config
        self.device = resolve_device(cfg.device)
        if self.model_config is None:
            if not cfg.model_path:
                raise ValueError("need model_config or model_path")
            self.model_config = ModelConfig.from_dir(cfg.model_path)
        mc = self.model_config
        cfg.block_size = cfg.resolve_block_size()
        if cfg.kv_cache_dtype not in _KV_DTYPES:
            raise ValueError(
                f"kv_cache_dtype {cfg.kv_cache_dtype!r} not supported "
                f"(one of {sorted(_KV_DTYPES)})"
            )
        if params is not None:
            self.params = params
        elif cfg.random_weights:
            init = init_params_quantized if cfg.quantization == "int8" else init_params
            if cfg.quantization not in (None, "int8"):
                raise ValueError(f"quantization {cfg.quantization!r} not supported")
            self.params = init(mc, cfg.seed, self.device)
        else:
            raise NotImplementedError(
                "checkpoint loading is not ported yet: use random_weights=True "
                "or pass params"
            )
        kv_dtype = _KV_DTYPES[cfg.kv_cache_dtype]
        num_blocks = cfg.num_blocks or self._auto_num_blocks(kv_dtype)
        self.k_cache, self.v_cache = llama.init_cache(
            mc, num_blocks, cfg.block_size, kv_dtype, self.device
        )
        self.allocator = BlockAllocator(
            num_blocks, cfg.block_size,
            enable_prefix_caching=cfg.enable_prefix_caching,
        )
        self.scheduler = Scheduler(
            self.allocator,
            cfg.block_size,
            max_batch_size=cfg.max_batch_size,
            prefill_chunk_size=cfg.prefill_chunk_size,
            max_model_len=cfg.max_model_len or mc.max_position_embeddings,
            max_prefill_tokens=cfg.max_prefill_tokens,
        )
        self.scheduler.on_finish = self._emit_finish

    def _auto_num_blocks(self, kv_dtype: torch.dtype) -> int:
        """Size the cache from free device memory after the weights."""
        if self.device.type != "cuda":
            raise ValueError("num_blocks must be given when device is not cuda")
        free, _total = torch.cuda.mem_get_info(self.device)
        # memory torch's caching allocator holds but no tensor uses is free
        # to this process too
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        budget = int(free * self.config.hbm_utilization) - _HEADROOM_BYTES
        per = cache_block_bytes(self.model_config, self.config.block_size, kv_dtype)
        n = budget // per
        if n < 2:
            raise RuntimeError(
                f"no room for a KV cache: {free} bytes free, {per} per block"
            )
        return int(n)

    async def shutdown(self) -> None:
        """Stop the engine thread and release the weights and the cache."""
        self._running = False
        self._wake.set()
        if self._thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._thread.join, 10
            )
            if self._thread.is_alive():
                raise RuntimeError("engine thread did not stop within 10 s")
        self.params = self.k_cache = self.v_cache = None
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # Engine thread
    # ------------------------------------------------------------------
    def _step_loop(self) -> None:
        assert self.scheduler is not None
        while self._running:
            self._drain_incoming()
            if not self.scheduler.has_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                self._one_step()
            except Exception:
                log.exception("engine step failed; failing in-flight requests")
                self._fail_all()

    def _drain_incoming(self) -> None:
        while True:
            try:
                seq = self._incoming.get_nowait()
            except thread_queue.Empty:
                return
            self.scheduler.add_request(seq)

    def _one_step(self) -> None:
        sched = self.scheduler
        t0 = time.monotonic()
        plan = sched.plan()
        if plan.kind == "idle":
            time.sleep(0.001)
            return
        if plan.kind == "prefill":
            arrays = sched.build_prefill_batch_arrays(plan.prefill_batch)
            seqs = [w.seq for w in plan.prefill_batch]
        else:
            seqs = plan.decode_seqs
            if not seqs:
                return
            arrays = sched.build_decode_arrays(seqs)
        B = arrays["tokens"].shape[0]
        next_tokens, logprobs = self._device_step(arrays, self._batch_sampling(seqs, B))
        self.steps[plan.kind] += 1
        self.step_seconds[plan.kind].append(time.monotonic() - t0)
        if plan.kind == "prefill":
            for i, work in enumerate(plan.prefill_batch):
                sched.complete_prefill_chunk(work)
                if work.is_last_chunk:
                    self._emit_token(work.seq, next_tokens[i], logprobs[i])
        else:
            for i, seq in enumerate(seqs):
                if seq.state == SeqState.RUNNING:
                    self._emit_token(seq, next_tokens[i], logprobs[i])

    def _device_step(self, arrays: dict, sampling: dict) -> tuple[list[int], list[float]]:
        """forward + sample on the device; the one host sync of a step is
        the copy of the sampled tokens and their logprobs."""
        dev = self.device

        def t(name):
            return torch.from_numpy(arrays[name]).to(dev, non_blocking=True)

        with torch.inference_mode():
            logits, self.k_cache, self.v_cache = llama.forward(
                self.model_config, self.params, self.k_cache, self.v_cache,
                t("tokens"), t("positions"), t("slot_mapping"),
                t("block_tables"), t("context_lens"), t("last_token_idx"),
                self.config.block_size,
            )
            tokens, lps = sample(logits, sampling)
        return tokens.cpu().tolist(), lps.cpu().tolist()

    def _batch_sampling(self, seqs: list[Sequence], B: int) -> dict:
        """Per-slot sampling params; a request's step seed is its base seed
        (or a crc32 of its id) plus the tokens it has generated, so its
        stream continues across steps and a resumed request."""
        opts = [s.request.sampling.normalized() for s in seqs]
        seeds = []
        for s in seqs:
            base = s.request.sampling.seed
            if base is None:
                base = zlib.crc32(s.request_id.encode()) & 0x7FFFFFFF
            seeds.append(base + s.generated + s.request.resume_offset)
        pad = B - len(seqs)
        return batch_arrays(opts + [opts[-1]] * pad, seeds + [0] * pad)

    def _emit_token(self, seq: Sequence, token: int, logprob: float) -> None:
        sched = self.scheduler
        sched.append_token(seq, token)
        reason = sched.should_finish(seq)
        if seq.emit is not None:
            seq.emit(LLMEngineOutput(
                request_id=seq.request_id, token_ids=[int(token)],
                log_probs=[float(logprob)],
            ))
        if reason is not None:
            sched.finish(seq, reason)

    def _emit_finish(self, seq: Sequence, reason: FinishReason) -> None:
        """Scheduler on_finish hook: close the request's output stream."""
        if seq.emit is not None:
            seq.emit(LLMEngineOutput(
                request_id=seq.request_id, finish_reason=reason,
                prompt_tokens=len(seq.request.token_ids),
                completion_tokens=seq.generated,
            ))
            seq.emit(None)  # sentinel: stream closed

    def _fail_all(self) -> None:
        sched = self.scheduler
        for seq in list(sched.running) + list(sched.prefilling) + list(sched.waiting):
            sched.finish(seq, FinishReason.ERROR)
        sched.running.clear()
        sched.prefilling.clear()
        sched.waiting.clear()

    # ------------------------------------------------------------------
    # Async interface
    # ------------------------------------------------------------------
    def submit(self, request: PreprocessedRequest, context: Context) -> asyncio.Queue:
        """Thread-safe submit; returns the asyncio output queue. Requests
        asking for what this engine does not do yet raise ValueError."""
        if self._loop is None or self.model_config is None:
            raise RuntimeError("engine not launched")
        self._validate(request)
        out: asyncio.Queue = asyncio.Queue()
        loop = self._loop

        def emit(item) -> None:
            loop.call_soon_threadsafe(out.put_nowait, item)

        seq = Sequence(
            request=request,
            tokens=TokenBlockSequence(request.token_ids, block_size=self.config.block_size),
            emit=emit,
            is_cancelled=lambda: context.is_stopped,
        )
        if context.deadline is not None:
            seq.deadline = context.deadline
        self._incoming.put(seq)
        self._wake.set()
        return out

    def _validate(self, request: PreprocessedRequest) -> None:
        if not request.token_ids:
            raise ValueError("empty token_ids")
        V = self.model_config.vocab_size
        ids = np.asarray(request.token_ids)
        if not np.issubdtype(ids.dtype, np.integer):
            raise ValueError("token_ids must be integers")
        if ids.min() < 0 or ids.max() >= V:
            raise ValueError(
                f"token id out of range [0, {V}): {int(ids.min())}..{int(ids.max())}"
            )
        s = request.sampling
        unsupported = []
        if s.logit_bias:
            unsupported.append("logit_bias")
        if s.needs_penalties:
            unsupported.append("frequency/presence/repetition penalties")
        if request.guided is not None:
            unsupported.append("guided decoding")
        if (request.output.logprobs or 0) > 0:
            unsupported.append("top logprobs")
        if request.mm_embeds:
            unsupported.append("multimodal embeddings")
        if unsupported:
            raise ValueError(
                "not supported by this engine yet: " + ", ".join(unsupported)
            )

    def as_async_engine(self) -> "TorchEngineAdapter":
        return TorchEngineAdapter(self)


class TorchEngineAdapter(AsyncEngine):
    """AsyncEngine facade: PreprocessedRequest in -> LLMEngineOutput stream."""

    def __init__(self, engine: TorchEngine):
        self.engine = engine

    async def _gen(self, request: Any, context: Context) -> AsyncIterator[Any]:
        if not isinstance(request, PreprocessedRequest):
            request = PreprocessedRequest.model_validate(request)
        out = self.engine.submit(request, context)
        while True:
            item = await out.get()
            if item is None:
                return
            yield item
            if isinstance(item, LLMEngineOutput) and item.is_final:
                return

    def generate(self, request: Any, context: Context) -> EngineStream:
        return self._gen(request, context)
