"""Decode steps at fixed shapes, captured once as CUDA graphs.

The port's counterpart of the reference engine's jitted step
(``_build_step_fn``: forward and sample as one program) and of its
``_prewarm`` (every serving shape compiled at launch). A decode shape is
(B, W): the padded batch and block-table width. Each shape owns one set
of static input buffers (``StepInputs``), and each (shape, sampling
variant) one ``torch.cuda.CUDAGraph`` of the whole step, all graphs
drawing on one memory pool. A step is then: stage its host arrays into a
pinned slot, copy them to the static inputs in one non-blocking copy,
optionally chain the token column on the device, replay.

With graphs off (``use_graphs=False``, and always on the CPU) the same
body runs eagerly over the same static buffers, so a captured step and
an eager one compute the same values in the same order. A failed capture
raises; nothing falls back to eager steps.

The kernel wrappers' ``.launches`` counts stay true: the launches a
capture records are taken back off the counts (nothing ran), remembered
with the graph, and added again at every replay.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.sampling import SAMPLING_DTYPES
from dynamo_tpu_torch.ops import paged_attention as _pa
from dynamo_tpu_torch.ops import qmatmul as _qm

log = logging.getLogger("dynamo_tpu_torch.engine.graphs")

# a step body: (static input views, sampled) -> (packed [2B] f32, tokens [B] i32)
StepBody = Callable[[dict, bool], tuple[torch.Tensor, torch.Tensor]]

# int32 words of the packed step inputs, in order: (name, words per row,
# dtype of the view). seeds (int64) come first so their view is 8-byte
# aligned; the block table takes W words a row.
_FIELDS = (
    ("seeds", 2, torch.int64),
    ("tokens", 1, torch.int32),
    ("positions", 1, torch.int32),
    ("slot_mapping", 1, torch.int32),
    ("context_lens", 1, torch.int32),
    ("last_token_idx", 1, torch.int32),
    ("src_idx", 1, torch.int32),
    ("temperature", 1, torch.float32),
    ("top_k", 1, torch.int32),
    ("top_p", 1, torch.float32),
    ("min_p", 1, torch.float32),
)
_NP = {torch.int64: np.int64, torch.int32: np.int32, torch.float32: np.float32}


def counted_wrappers() -> tuple:
    """The kernel wrappers whose ``.launches`` a graph keeps true."""
    return (_qm.qmm, _qm.qmm_gate_up, _qm.qmm_lm_head,
            _pa.paged_attention_decode_stacked, _pa.paged_attention_prefill_stacked)


def _counts() -> list[int]:
    return [fn.launches for fn in counted_wrappers()]


def _views(buf, B: int, W: int, to_shape) -> dict:
    """Typed views of one packed int32 buffer (torch tensor or numpy
    array) of a (B, W) layout."""
    out, at = {}, 0
    for name, words, dt in _FIELDS:
        out[name] = to_shape(buf[at:at + words * B], dt, (B,))
        at += words * B
    out["block_tables"] = to_shape(buf[at:at + B * W], torch.int32, (B, W))
    for name in ("tokens", "positions"):
        out[name] = out[name].reshape(B, 1)
    return out


class StepInputs:
    """The static inputs of one decode shape (B, W) on the device, and a
    ring of ``depth`` host staging slots (pinned on a CUDA device) that
    fill them in one copy. A slot is refilled only after its previous
    copy has run (its event), so a step still queued on the device never
    reads a slot the host is rewriting."""

    def __init__(self, B: int, W: int, device: torch.device, depth: int):
        self.B, self.W, self.device = B, W, device
        n = sum(words for _, words, _ in _FIELDS) * B + B * W
        self.dev = torch.zeros(n, dtype=torch.int32, device=device)
        self.views = _views(self.dev, B, W,
                            lambda t, dt, shape: t.view(dt).reshape(shape))
        cuda = device.type == "cuda"
        self.staging = [torch.zeros(n, dtype=torch.int32, pin_memory=cuda)
                        for _ in range(depth)]
        self.events = [torch.cuda.Event() if cuda else None for _ in range(depth)]
        self._next = 0

    def stage(self, arrays: dict, sampling: dict, src_idx: Optional[np.ndarray] = None) -> None:
        """Copy one step's host arrays to the static inputs (enqueued on
        the current stream; non-blocking from pinned memory)."""
        i = self._next
        self._next = (i + 1) % len(self.staging)
        if self.events[i] is not None:
            self.events[i].synchronize()
        host = self.staging[i].numpy()
        v = _views(host, self.B, self.W,
                   lambda a, dt, shape: a.view(_NP[dt]).reshape(shape))
        for name in ("tokens", "positions", "slot_mapping", "context_lens",
                     "last_token_idx", "block_tables"):
            v[name][...] = arrays[name]
        for name in SAMPLING_DTYPES:
            v[name][...] = sampling[name]
        v["src_idx"][...] = 0 if src_idx is None else src_idx
        self.dev.copy_(self.staging[i], non_blocking=True)
        if self.events[i] is not None:
            self.events[i].record()

    def chain(self, prev_tokens: torch.Tensor) -> None:
        """The token column from an in-flight step's sampled tokens,
        gathered on the device by the staged ``src_idx`` (the reference's
        ``chain_next``): no host round trip between steps."""
        self.views["tokens"][:, 0] = prev_tokens.index_select(0, self.views["src_idx"])

    def fill_dummy(self) -> None:
        """Warm-up and capture inputs: every row writes the garbage slot
        0 of block 0 and attends over no key (ctx 0)."""
        self.dev.zero_()


class _Captured:
    def __init__(self, graph: torch.cuda.CUDAGraph, outputs, launches: list[int]):
        self.graph, self.outputs, self.launches = graph, outputs, launches

    def replay(self):
        self.graph.replay()
        for fn, n in zip(counted_wrappers(), self.launches):
            fn.launches += n
        return self.outputs


class DecodeGraphs:
    """Decode steps by shape: static inputs per (B, W), one graph per (B,
    W, sampled) when ``use_graphs``. ``prewarm`` captures the given shapes
    now; any other shape is captured at its first step."""

    def __init__(self, body: StepBody, device: torch.device, use_graphs: bool,
                 depth: int):
        if use_graphs and device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.body = body
        self.device = device
        self.use_graphs = use_graphs
        self.depth = depth
        self.inputs: dict[tuple[int, int], StepInputs] = {}
        self.graphs: dict[tuple[int, int, bool], _Captured] = {}
        self.pool = torch.cuda.graph_pool_handle() if use_graphs else None
        self.capture_seconds = 0.0
        # growth of the device memory torch reserves across the captures:
        # the graphs' pool plus the static inputs
        self.pool_bytes = 0

    def inputs_for(self, B: int, W: int) -> StepInputs:
        inp = self.inputs.get((B, W))
        if inp is None:
            inp = self.inputs[(B, W)] = StepInputs(B, W, self.device, self.depth)
        return inp

    def prewarm(self, batches: list[int], W: int) -> None:
        for B in batches:
            for sampled in (False, True):
                self._capture(B, W, sampled)

    def prepare(self, B: int, W: int, sampled: bool) -> StepInputs:
        """The shape's static inputs, its graph captured first if it has
        none yet (a capture overwrites the inputs: stage after this)."""
        if self.use_graphs and (B, W, sampled) not in self.graphs:
            self._capture(B, W, sampled)
        return self.inputs_for(B, W)

    def run(self, B: int, W: int, sampled: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """Enqueue one step of shape (B, W) over its staged inputs
        (``prepare`` first); returns its (packed, tokens) device outputs
        (a graph's static outputs, valid until its next replay)."""
        if not self.use_graphs:
            return self.body(self.inputs_for(B, W).views, sampled)
        return self.graphs[(B, W, sampled)].replay()

    def _capture(self, B: int, W: int, sampled: bool) -> _Captured:
        dev = self.device
        t0 = time.monotonic()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        inp = self.inputs_for(B, W)
        inp.fill_dummy()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.body(inp.views, sampled)  # eager warm-up: real launches
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                outputs = self.body(inp.views, sampled)
        except Exception as exc:
            raise RuntimeError(
                f"CUDA graph capture failed for decode shape B={B} W={W} "
                f"({'sampled' if sampled else 'greedy'})"
            ) from exc
        finally:
            captured = [a - b for a, b in zip(_counts(), before)]
            for fn, b in zip(counted_wrappers(), before):
                fn.launches = b  # the capture ran nothing
        g = self.graphs[(B, W, sampled)] = _Captured(graph, outputs, captured)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved0
        dt = time.monotonic() - t0
        self.capture_seconds += dt
        log.info("captured decode B=%d W=%d %s in %.2f s (%d kernel launches)",
                 B, W, "sampled" if sampled else "greedy", dt, sum(captured))
        return g
