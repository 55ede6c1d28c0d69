"""The serving engine: continuous batching over the port's model.

``TorchEngine`` has the reference engine's public surface for its
single-token path: ``launch(config)``, ``submit``, ``as_async_engine()``
and the adapter's ``generate`` (a ``PreprocessedRequest`` in, a stream of
``LLMEngineOutput`` out). A dedicated engine thread plans steps
(scheduler), dispatches them to the device and emits their tokens.

Decode runs the reference's default path:
- static serving shapes: a few padded batch buckets and one block-table
  width (``Scheduler.apply_static_shapes``);
- each decode shape a CUDA graph of forward + sample, captured at launch
  (``engine/graphs.py``; ``cuda_graphs`` off runs the same step eagerly);
- the overlapped decode pipeline (``_decode_pipeline``): step N+1 is
  planned and dispatched while step N runs, its token column chained on
  the device, and step N's outputs come back in one packed copy.
Prefill steps run eagerly. Not ported yet: speculative decoding, fused
windows and mixed steps, KV offload tiers, guided decoding, penalties.

The engine runs on ``config.device``: "cuda" (the default) launches the
port's CUDA kernels and fails if no GPU is present; "cpu" runs their
plain versions (tests).
"""

from __future__ import annotations

import asyncio
import gc
import logging
import queue as thread_queue
import threading
import time
import zlib
from collections import deque
from typing import Any, AsyncIterator, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.allocator import BlockAllocator
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.graphs import DecodeGraphs
from dynamo_tpu_torch.engine.sampling import (
    any_sampled,
    batch_arrays,
    pack_pair,
    sample,
    sampling_tensors,
)
from dynamo_tpu_torch.engine.scheduler import Scheduler, SeqState, Sequence
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.models.quant import init_params, init_params_quantized
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context, EngineStream
from dynamo_tpu_torch.telemetry.overlap import OverlapTracker
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger("dynamo_tpu_torch.engine")

_KV_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}
# device memory kept free beside an auto-sized cache: step activations,
# logits and the sampling noise of a full batch, and the decode graphs'
# memory pool
_HEADROOM_BYTES = 4 << 30


def _lag_add(lag: dict, entry: dict) -> None:
    """Charge an in-flight entry to the pipeline's lag ledger: ``vmap``
    maps id(seq) -> tokens the entry will add, sampled on the device but
    not yet applied to host state (``plan_pipelined_decode`` reads it)."""
    for sid, v in entry["vmap"].items():
        lag[sid] = lag.get(sid, 0) + v


def _lag_sub(lag: dict, entry: dict) -> None:
    """Release a harvested entry's charges from the lag ledger."""
    for sid, v in entry["vmap"].items():
        left = lag.get(sid, 0) - v
        if left > 0:
            lag[sid] = left
        else:
            lag.pop(sid, None)


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
    # steps the overlapped decode pipeline keeps in flight
    PIPELINE_DEPTH = 2

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
        # wall seconds of each step by kind, host clock: serial steps from
        # plan to emit; pipelined decode steps from the previous harvest
        # (or the dispatch, if later) to this one's emit, so a run's steps
        # sum to its wall time
        self.step_seconds: dict[str, list[float]] = {"prefill": [], "decode": []}
        # per step, beside step_seconds: plan_ms, dispatch_ms, sync_ms,
        # idle_gap_ms (device idle before the dispatch, OverlapTracker),
        # and for pipelined steps overlap_ms (host time the step ran under)
        # and pipeline_depth
        self.step_stamps: dict[str, list[dict]] = {"prefill": [], "decode": []}
        # device ms of each step by kind, from CUDA events around its
        # device work (inputs copy to outputs copy); off unless set
        self.record_device_time = False
        self.device_ms: dict[str, list[float]] = {"prefill": [], "decode": []}
        self.overlap = OverlapTracker()
        self.use_graphs = False
        self.decode: Optional[DecodeGraphs] = None
        # pinned host slots for the packed step outputs, a ring of
        # PIPELINE_DEPTH + 1: a slot is reused only after its harvest
        self._out_slots: list[Optional[torch.Tensor]] = []
        self._out_events: list[Any] = []
        self._out_next = 0
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
        self.use_graphs = cfg.resolve_cuda_graphs()
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
        sched = self.scheduler = Scheduler(
            self.allocator,
            cfg.block_size,
            max_batch_size=cfg.max_batch_size,
            prefill_chunk_size=cfg.prefill_chunk_size,
            max_model_len=cfg.max_model_len or mc.max_position_embeddings,
            max_prefill_tokens=cfg.max_prefill_tokens,
        )
        sched.on_finish = self._emit_finish
        if cfg.static_shapes:
            sched.apply_static_shapes(
                cfg.max_batch_size,
                cfg.max_model_len or mc.max_position_embeddings,
                num_blocks,
                decode_batch_mid=cfg.decode_batch_mid,
            )
        depth = self.PIPELINE_DEPTH + 1
        self._out_slots = [None] * depth
        self._out_events = [
            torch.cuda.Event() if self.device.type == "cuda" else None
            for _ in range(depth)
        ]
        self.decode = DecodeGraphs(self._step_body, self.device, self.use_graphs, depth)
        if self.device.type == "cuda":
            _build.build_all()
        if self.use_graphs and cfg.resolve_prewarm() and sched.table_width_pad is not None:
            with torch.inference_mode():
                self.decode.prewarm(sched.decode_buckets(), sched.table_width_pad)

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
        self.decode = None
        self._out_slots = []
        self._out_events = []
        if self.device is not None and self.device.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # Engine thread
    # ------------------------------------------------------------------
    def _step_loop(self) -> None:
        assert self.scheduler is not None
        while self._running:
            self._drain_incoming()
            if not self.scheduler.has_work:
                self.overlap.note_idle()
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                with torch.inference_mode():
                    self._one_step()
            except Exception:
                log.exception("engine step failed; failing in-flight requests")
                self.overlap.reset()
                self._fail_all()

    def _drain_incoming(self) -> None:
        while True:
            try:
                item = self._incoming.get_nowait()
            except thread_queue.Empty:
                return
            for seq in item if isinstance(item, list) else [item]:
                self.scheduler.add_request(seq)

    def _one_step(self) -> None:
        sched = self.scheduler
        t0 = time.monotonic()
        plan = sched.plan()
        plan_ms = round((time.monotonic() - t0) * 1e3, 3)
        if plan.kind == "idle":
            time.sleep(0.001)
            return
        if plan.kind == "prefill":
            seqs = [w.seq for w in plan.prefill_batch]
            arrays = sched.build_prefill_batch_arrays(plan.prefill_batch)
        else:
            seqs = plan.decode_seqs
            if not seqs:
                return
            if self._overlap_ok() and not self._overlap_divert(seqs):
                # dispatch N+1 before harvesting N, so the device does not
                # wait out the host's plan and emit; overlap=False keeps
                # the serial step below
                self._decode_pipeline(seqs, plan_ms=plan_ms)
                return
            arrays = sched.build_decode_arrays(seqs)
        B = arrays["tokens"].shape[0]
        entry = self._dispatch_device_step(
            arrays, self._batch_sampling(seqs, B), plan.kind
        )
        next_tokens, logprobs = self._harvest_device_step(entry)
        self._record_step(plan.kind, time.monotonic() - t0, plan_ms=plan_ms,
                          **entry["phases"])
        if plan.kind == "prefill":
            for i, work in enumerate(plan.prefill_batch):
                sched.complete_prefill_chunk(work)
                if work.is_last_chunk:
                    self._emit_token(work.seq, next_tokens[i], logprobs[i])
        else:
            for i, seq in enumerate(seqs):
                if seq.state == SeqState.RUNNING:
                    self._emit_token(seq, next_tokens[i], logprobs[i])

    def _record_step(self, kind: str, seconds: float, **stamps) -> None:
        self.steps[kind] += 1
        self.step_seconds[kind].append(seconds)
        self.step_stamps[kind].append(stamps)

    # ------------------------------------------------------------------
    # Device steps: dispatch, then harvest
    # ------------------------------------------------------------------
    def _step_body(self, inp: dict, sampled: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """One step on device tensors: forward and sample, as a decode
        graph captures it. Returns (packed [2B] f32, tokens [B])."""
        logits, _, _ = llama.forward(
            self.model_config, self.params, self.k_cache, self.v_cache,
            inp["tokens"], inp["positions"], inp["slot_mapping"],
            inp["block_tables"], inp["context_lens"], inp["last_token_idx"],
            self.config.block_size,
        )
        tokens, lps = sample(logits, inp, sampled)
        return pack_pair(tokens, lps), tokens

    def _copy_out(self, packed: torch.Tensor):
        """Enqueue the packed outputs' copy into the next pinned host slot;
        returns (host view, its event)."""
        i = self._out_next
        self._out_next = (i + 1) % len(self._out_slots)
        n = packed.shape[0]
        cuda = self.device.type == "cuda"
        buf = self._out_slots[i]
        if buf is None or buf.shape[0] < n:
            buf = self._out_slots[i] = torch.empty(n, dtype=torch.float32, pin_memory=cuda)
        out = buf[:n]
        out.copy_(packed, non_blocking=cuda)
        event = self._out_events[i]
        if event is not None:
            event.record()
        return out, event

    def _dispatch_device_step(
        self,
        arrays: dict,
        sampling: dict,
        kind: str,
        src_idx: Optional[np.ndarray] = None,
        chain_from: Optional[torch.Tensor] = None,
    ) -> dict:
        """DISPATCH half of a device step: stage the inputs, run the step
        (a decode shape's graph, or the eager prefill), enqueue the copy
        of its packed outputs to a pinned slot, and return without a host
        sync. ``chain_from``: the in-flight step's sampled tokens, from
        which this step's token column is gathered by ``src_idx`` on the
        device."""
        B, T = arrays["tokens"].shape
        sampled = any_sampled(sampling)
        timer = None
        if self.record_device_time and self.device.type == "cuda":
            timer = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
        if T == 1:
            W = arrays["block_tables"].shape[1]
            inp = self.decode.prepare(B, W, sampled)
        idle_gap_s = self.overlap.note_dispatch()
        t_disp = time.monotonic()
        if timer is not None:
            timer[0].record()
        if T == 1:
            inp.stage(arrays, sampling, src_idx)
            if chain_from is not None:
                inp.chain(chain_from)
            packed, tokens = self.decode.run(B, W, sampled)
        else:  # prefill, eagerly: the arrays uploaded one by one
            tensors = {k: torch.from_numpy(a).to(self.device, non_blocking=True)
                       for k, a in arrays.items()}
            tensors.update(sampling_tensors(sampling, self.device))
            packed, tokens = self._step_body(tensors, sampled)
        out, event = self._copy_out(packed)
        if timer is not None:
            timer[1].record()
        return {
            "out": out, "event": event, "toks": tokens, "b": B, "kind": kind,
            "timer": timer, "t_disp": t_disp,
            "phases": {
                "dispatch_ms": round((time.monotonic() - t_disp) * 1e3, 3),
                "idle_gap_ms": round(idle_gap_s * 1e3, 3),
            },
        }

    def _harvest_device_step(self, entry: dict, all_prior: bool = True):
        """HARVEST half: the one host sync of a step, on its output copy's
        event; returns (tokens, logprobs) as lists of its B rows."""
        t0 = time.monotonic()
        if entry["event"] is not None:
            entry["event"].synchronize()
        vals = entry["out"].tolist()
        self.overlap.note_complete(all_prior=all_prior)
        entry["phases"]["sync_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        timer = entry["timer"]
        if timer is not None:
            timer[1].synchronize()
            self.device_ms[entry["kind"]].append(timer[0].elapsed_time(timer[1]))
        B = entry["b"]
        return [int(x) for x in vals[:B]], vals[B:2 * B]

    # ------------------------------------------------------------------
    # Overlapped single-step decode
    # ------------------------------------------------------------------
    def _overlap_ok(self) -> bool:
        """The overlapped pipeline runs unless the config turns it off
        (the reference also needs a single host and pp = 1, which is all
        the port has)."""
        return self.config.overlap

    def _overlap_divert(self, seqs: list) -> bool:
        """Batches that must take the serial step instead of the
        overlapped pipeline: penalty and bias counts live on the host one
        step behind dispatch, top-logprobs is another step variant, and a
        guided step's allow-mask depends on the previous step's token.
        ``submit`` rejects all of these today, so nothing diverts yet."""
        return any(
            (s.request.output.logprobs or 0) > 0
            or s.request.sampling.needs_penalties
            or s.request.sampling.logit_bias
            or s.request.guided is not None
            for s in seqs
        )

    def _decode_pipeline(self, seqs: list, plan_ms: float = 0.0) -> None:
        """Double-buffered single-step decode (the reference's
        ``_decode_pipeline``):

        - while step N runs on the device, the host plans AND dispatches
          step N+1, its token column chained on the device from N's
          sampled tokens: per-step host-to-device traffic is the small
          position/slot/seed arrays only;
        - step N's packed [2B] output is harvested only after N+1 is in
          flight, so the sync waits on a result that is already (or
          nearly) done;
        - scheduler state (token appends, stop checks, block frees,
          prefix-cache commits) runs one step behind dispatch.
          ``plan_pipelined_decode`` predicts every ``should_finish``
          condition a step ahead, so an in-flight step never writes KV
          into blocks a harvest-time ``finish()`` frees; a token sampled
          past a late-detected stop (cancellation, deadline) is discarded
          at harvest, never appended, emitted or content-addressed, and
          the pipeline flushes so ``plan()`` reaps with nothing in flight;
        - the pipeline never preempts and never admits: block pressure or
          new arrivals drain it back to the serial planner.

        Output is bit-identical to the serial loop (the same step over
        the same values); sampled rows draw the same seeds (offset by the
        in-flight lag).
        """
        sched = self.scheduler
        lag: dict[int, int] = {}
        last_end: list[float] = []

        def _dead(seq) -> bool:
            if seq.is_cancelled and seq.is_cancelled():
                return True
            return bool(seq.deadline) and time.monotonic() >= seq.deadline

        def dispatch(seqs_, arrays, sampling, p_ms, src_idx=None, chain_from=None):
            e = self._dispatch_device_step(
                arrays, sampling, "decode", src_idx=src_idx, chain_from=chain_from
            )
            e.update(seqs=seqs_, vmap={id(s): 1 for s in seqs_}, plan_ms=p_ms)
            return e

        def try_extend() -> bool:
            newest = pending[-1]
            self._drain_incoming()
            if sched.waiting or sched.prefilling:
                return False  # drain: the serial planner admits/prefills
            t_plan = time.monotonic()
            nxt = sched.plan_pipelined_decode(newest["seqs"], lag)
            if nxt is None:
                return False
            arrays = nxt["arrays"]
            sampling = self._batch_sampling(
                nxt["seqs"], arrays["context_lens"].shape[0], offset=nxt["offsets"]
            )
            e = dispatch(
                nxt["seqs"], arrays, sampling,
                round((time.monotonic() - t_plan) * 1e3, 3),
                src_idx=nxt["src_idx"], chain_from=newest["toks"],
            )
            _lag_add(lag, e)
            pending.append(e)
            return True

        def harvest(e, depth: int) -> bool:
            t0 = time.monotonic()
            toks, lps = self._harvest_device_step(e, all_prior=False)
            finished = False
            for i, seq in enumerate(e["seqs"]):
                if seq.state != SeqState.RUNNING:
                    continue
                if _dead(seq):
                    # late-detected stop: discard the in-flight token
                    finished = True
                    continue
                self._emit_token(seq, toks[i], lps[i])
                if seq.state != SeqState.RUNNING:
                    finished = True
            _lag_sub(lag, e)
            now = time.monotonic()
            start = max(e["t_disp"], last_end[0]) if last_end else e["t_disp"]
            last_end[:] = [now]
            self._record_step(
                "decode", now - start, plan_ms=e["plan_ms"],
                # host time this step ran under (planning and dispatching
                # N+1, emitting N-1): the overlapped span
                overlap_ms=round((t0 - e["t_disp"]) * 1e3, 3),
                pipeline_depth=depth, **e["phases"],
            )
            return finished

        arrays = sched.build_decode_arrays(seqs)
        entry = dispatch(
            seqs, arrays, self._batch_sampling(seqs, arrays["tokens"].shape[0]), plan_ms
        )
        _lag_add(lag, entry)
        pending = deque([entry])
        while pending:
            # extend BEFORE harvesting: nothing has been freed since the
            # last harvest, so planning here never touches blocks an
            # in-flight step writes
            while len(pending) < self.PIPELINE_DEPTH and self._running:
                if not try_extend():
                    break
            finished = harvest(pending.popleft(), depth=len(pending) + 1)
            if finished and pending:
                # a finish freed blocks (or a stop was seen) with a step in
                # flight: flush so plan()/admission and the reap run with
                # nothing in flight
                while pending:
                    harvest(pending.popleft(), depth=len(pending))
                return

    def _batch_sampling(self, seqs: list[Sequence], B: int, offset=0) -> dict:
        """Per-slot sampling params; a request's step seed is its base seed
        (or a crc32 of its id) plus the tokens it has generated, so its
        stream continues across steps and a resumed request. ``offset``
        (an int, or one per sequence) advances the seeds past the tokens
        of an in-flight step not yet applied on the host."""
        opts = [s.request.sampling.normalized() for s in seqs]
        offs = offset if isinstance(offset, list) else [offset] * len(seqs)
        seeds = []
        for s, off in zip(seqs, offs):
            base = s.request.sampling.seed
            if base is None:
                base = zlib.crc32(s.request_id.encode()) & 0x7FFFFFFF
            seeds.append(base + s.generated + s.request.resume_offset + off)
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
        seq, out = self._make_seq(request, context)
        self._incoming.put(seq)
        self._wake.set()
        return out

    def submit_many(
        self, items: list[tuple[PreprocessedRequest, Context]]
    ) -> list[asyncio.Queue]:
        """Submit several requests at once: they reach the scheduler
        together and are admitted by the same plan (a burst, such as a
        benchmark's), so how they are batched does not depend on when the
        engine thread wakes. Validates every request before queueing any."""
        made = [self._make_seq(r, c) for r, c in items]
        self._incoming.put([seq for seq, _ in made])
        self._wake.set()
        return [out for _, out in made]

    def _make_seq(self, request: PreprocessedRequest, context: Context):
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
        return seq, out

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
