"""Continuous-batching scheduler: admission, chunked prefill, decode
batches, and the plan of the overlapped decode pipeline.

The port's copy of the reference scheduler's serial path: a waiting
request is admitted against the block allocator (prefix blocks reused),
its prompt runs in chunks of at most ``prefill_chunk_size`` tokens, and
then it decodes one token per step. One prefill batch or one decode batch
per engine step; on block exhaustion the youngest running sequence is
rolled back to the waiting queue (recompute preemption).
``plan_pipelined_decode`` plans the next decode step while one is in
flight; it never preempts.

Step arrays keep the reference's bucketed shapes (batch and chunk length
rounded up to a small set of sizes, block-table width to a multiple of
8) so a step here is laid out exactly like the same step there. With
static shapes (``apply_static_shapes``) a decode batch pads to one of at
most three buckets and every block table to one width, so decode runs a
fixed set of shapes. Padded rows and tokens write to the garbage slot 0
of block 0.

Pure host-side logic: no tensors, no device.
"""

from __future__ import annotations

import enum
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from dynamo_tpu_torch.engine.allocator import BlockAllocator, NoBlocksError
from dynamo_tpu_torch.protocols.common import FinishReason, PreprocessedRequest
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger("dynamo_tpu_torch.engine.scheduler")


def next_bucket(n: int, buckets: list[int]) -> int:
    """Smallest bucket >= n (the largest bucket's multiple past the end)."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return -(-n // top) * top


class SeqState(str, enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class Sequence:
    request: PreprocessedRequest
    tokens: TokenBlockSequence
    state: SeqState = SeqState.WAITING
    block_table: list[int] = field(default_factory=list)
    num_computed: int = 0  # tokens whose KV is in cache
    num_cached_prompt: int = 0  # prefix-cache hit length (tokens)
    committed_blocks: int = 0  # prefix of block_table already content-addressed
    generated: int = 0
    arrival: int = 0
    # engine-facing hooks
    emit: Optional[Callable] = None
    is_cancelled: Optional[Callable[[], bool]] = None
    finish_reason: Optional[FinishReason] = None
    # request deadline (monotonic instant; 0.0 = none)
    deadline: float = 0.0

    @property
    def request_id(self) -> str:
        return self.request.request_id

    @property
    def total_len(self) -> int:
        return len(self.tokens)

    @property
    def max_new_tokens(self) -> Optional[int]:
        return self.request.stop.max_tokens

    def blocks_needed(self, for_len: int, block_size: int) -> int:
        return (for_len + block_size - 1) // block_size


@dataclass
class PrefillWork:
    """One chunk of prompt to run this step."""

    seq: Sequence
    tokens: np.ndarray  # [t] token ids for this chunk
    start_pos: int  # absolute position of tokens[0]
    is_last_chunk: bool


@dataclass
class StepPlan:
    """What the engine should run this step."""

    kind: str  # "prefill" | "decode" | "idle"
    prefill_batch: list[PrefillWork] = field(default_factory=list)
    decode_seqs: list[Sequence] = field(default_factory=list)


class Scheduler:
    BATCH_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256]
    CHUNK_BUCKETS = [16, 32, 64, 128, 256, 512, 1024, 2048, 4096]
    TABLE_BUCKET = 8  # block-table width rounded to multiples of this

    def __init__(
        self,
        allocator: BlockAllocator,
        block_size: int,
        max_batch_size: int = 64,
        prefill_chunk_size: int = 1024,
        max_model_len: Optional[int] = None,
        max_prefill_tokens: Optional[int] = None,
    ):
        self.allocator = allocator
        self.block_size = block_size
        self.max_batch_size = max_batch_size
        self.prefill_chunk_size = prefill_chunk_size
        self.max_model_len = max_model_len
        # total token budget (padded rectangle) of one batched prefill step
        self.max_prefill_tokens = max_prefill_tokens or prefill_chunk_size
        self.waiting: deque[Sequence] = deque()
        self.prefilling: deque[Sequence] = deque()
        self.running: list[Sequence] = []
        self._arrival = 0
        # invoked on every finish (incl. cancellations reaped inside plan())
        self.on_finish: Optional[Callable[[Sequence, FinishReason], None]] = None
        # static serving shapes (apply_static_shapes; None = bucketed)
        self.decode_batch_pad: Optional[int] = None
        self.decode_batch_small: Optional[int] = None
        self.decode_batch_mid: Optional[int] = None
        self.table_width_pad: Optional[int] = None
        self.preemptions = 0

    def apply_static_shapes(
        self,
        max_batch_size: int,
        max_len: int,
        num_blocks: int,
        decode_batch_mid: Optional[int] = None,
        decode_steps: int = 1,
    ) -> None:
        """One set of decode shapes (the reference engine's static-shape
        setup, its decode part): the batch pads to ``max_batch_size``'s
        bucket, with a small bucket of 4 and a mid bucket (pad/2 from a
        pad of 64, or ``decode_batch_mid``'s largest bucket strictly
        between them; 0 = none); every block table pads to the
        ``max_len`` cap, itself capped by the cache."""
        self.decode_batch_pad = next_bucket(max_batch_size, self.BATCH_BUCKETS)
        if self.decode_batch_pad > 4:
            self.decode_batch_small = 4
        if decode_batch_mid is not None:
            lo = self.decode_batch_small or 0
            fits = [
                b for b in self.BATCH_BUCKETS
                if lo < b < self.decode_batch_pad and b <= decode_batch_mid
            ]
            if decode_batch_mid > 0 and fits:
                self.decode_batch_mid = fits[-1]
            elif decode_batch_mid > 0:
                log.warning(
                    "decode_batch_mid=%d has no bucket strictly between the "
                    "small bucket (%d) and the pad (%d); ignoring the override",
                    decode_batch_mid, lo, self.decode_batch_pad,
                )
        elif self.decode_batch_pad >= 64:
            self.decode_batch_mid = self.decode_batch_pad // 2
        blocks_cap = min(
            -(-(max_len + max(1, decode_steps)) // self.block_size) + 1,
            num_blocks,
        )
        self.table_width_pad = max(
            self.TABLE_BUCKET,
            -(-blocks_cap // self.TABLE_BUCKET) * self.TABLE_BUCKET,
        )

    def decode_buckets(self) -> list[int]:
        """The decode batch shapes of a static-shape scheduler."""
        return sorted({b for b in (self.decode_batch_small, self.decode_batch_mid,
                                   self.decode_batch_pad) if b is not None})

    # -- intake -----------------------------------------------------------
    def add_request(self, seq: Sequence) -> None:
        seq.arrival = self._arrival
        self._arrival += 1
        self.waiting.append(seq)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running)

    # -- planning ---------------------------------------------------------
    def plan(self) -> StepPlan:
        """Serial plan: reap cancelled/expired sequences, admit, then one
        prefill batch if any prompt is pending, else one decode batch."""
        self._reap_cancelled()
        self._admit()
        if self.prefilling:
            works = self._plan_prefill_batch()
            if works:
                return StepPlan(kind="prefill", prefill_batch=works)
        if self.running:
            return StepPlan(kind="decode", decode_seqs=self._plan_decode())
        return StepPlan(kind="idle")

    def _reap_cancelled(self) -> None:
        """Finish cancelled and deadline-expired sequences in every pool;
        finish() frees their KV blocks."""
        now = time.monotonic()

        def reason(seq: Sequence) -> Optional[FinishReason]:
            if seq.is_cancelled and seq.is_cancelled():
                return FinishReason.CANCELLED
            if seq.deadline and now >= seq.deadline:
                log.warning("request %s deadline expired", seq.request_id)
                return FinishReason.TIMEOUT
            return None

        for pool in (self.waiting, self.prefilling, self.running):
            for seq in list(pool):
                r = reason(seq)
                if r is not None:
                    pool.remove(seq)
                    self.finish(seq, r)

    def _growth_reserve(self) -> int:
        """Blocks the current population still needs to finish its
        generations; admission leaves this many free so that admitting a
        prompt does not force the next decode step to preempt."""
        r = 0
        for seq in list(self.running) + list(self.prefilling):
            if seq.max_new_tokens is not None:
                end = seq.total_len + max(0, seq.max_new_tokens - seq.generated)
            else:
                end = seq.total_len + 1
            r += max(
                0,
                seq.blocks_needed(end, self.block_size) - len(seq.block_table),
            )
        return r

    def _admit(self) -> None:
        reserve = None  # computed lazily, refreshed per admission
        while self.waiting and (
            len(self.running) + len(self.prefilling) < self.max_batch_size
        ):
            seq = self.waiting[0]
            if self.max_model_len and seq.total_len >= self.max_model_len:
                self.waiting.popleft()
                self.finish(seq, FinishReason.ERROR)
                continue
            seq_hashes = seq.tokens.sequence_hashes()
            n_prompt_blocks = seq.blocks_needed(seq.total_len, self.block_size)
            if reserve is None:
                reserve = self._growth_reserve()
            free_need = self.allocator.free_need(
                seq_hashes[:n_prompt_blocks], n_prompt_blocks
            )
            if self.allocator.num_free < free_need + reserve:
                break  # backpressure: the population's growth comes first
            reserve += seq.blocks_needed(
                seq.total_len + (seq.max_new_tokens or 1), self.block_size
            ) - n_prompt_blocks
            try:
                complete = seq_hashes[:n_prompt_blocks]
                blocks, cached = self.allocator.allocate_prefix(complete)
                try:
                    for _ in range(n_prompt_blocks - len(complete)):
                        blocks.append(self.allocator.allocate_block())
                except NoBlocksError:
                    self.allocator.free_sequence(blocks)
                    raise
            except NoBlocksError:
                break  # backpressure: try again next step
            self.waiting.popleft()
            seq.block_table = blocks
            seq.num_cached_prompt = cached * self.block_size
            seq.num_computed = seq.num_cached_prompt
            seq.committed_blocks = cached
            seq.state = SeqState.PREFILL
            self.prefilling.append(seq)

    def _plan_prefill_batch(self) -> list[PrefillWork]:
        """One chunk from each of several prefilling sequences, fused into
        a single step whose padded [B, T] rectangle stays within
        max_prefill_tokens."""
        budget = self.max_prefill_tokens
        works: list[PrefillWork] = []
        max_chunk = 0
        for seq in self.prefilling:
            if len(works) >= self.max_batch_size:
                break
            prompt = seq.tokens.all_tokens()
            start = seq.num_computed
            remaining = len(prompt) - start
            if remaining <= 0:
                # fully cached prompt: recompute the last token so there
                # are logits to sample from
                start = max(0, len(prompt) - 1)
                remaining = len(prompt) - start
            chunk = min(remaining, self.prefill_chunk_size, budget)
            new_max = max(max_chunk, chunk)
            area = (
                next_bucket(len(works) + 1, self.BATCH_BUCKETS)
                * next_bucket(new_max, self.CHUNK_BUCKETS)
            )
            cur_area = (
                next_bucket(len(works), self.BATCH_BUCKETS)
                * next_bucket(max_chunk, self.CHUNK_BUCKETS)
                if works else 0
            )
            if works and area > budget and area > cur_area:
                break
            works.append(
                PrefillWork(
                    seq=seq,
                    tokens=np.asarray(prompt[start : start + chunk], np.int32),
                    start_pos=start,
                    is_last_chunk=(start + chunk >= len(prompt)),
                )
            )
            max_chunk = new_max
        return works

    def complete_prefill_chunk(self, work: PrefillWork) -> None:
        seq = work.seq
        seq.num_computed = work.start_pos + len(work.tokens)
        self._commit_full_blocks(seq)
        if work.is_last_chunk:
            self.prefilling.remove(seq)
            seq.state = SeqState.RUNNING
            self.running.append(seq)

    def _plan_decode(self) -> list[Sequence]:
        """Ensure each running seq has a slot for its next token; on block
        exhaustion preempt the youngest running sequence (possibly the
        requester itself) back to waiting."""
        batch = sorted(self.running, key=lambda s: s.arrival)[: self.max_batch_size]
        safe: list[Sequence] = []
        for seq in batch:
            if seq.state != SeqState.RUNNING:
                continue  # preempted earlier in this pass
            needed_blocks = seq.blocks_needed(seq.total_len + 1, self.block_size)
            while (
                seq.state == SeqState.RUNNING
                and len(seq.block_table) < needed_blocks
            ):
                try:
                    seq.block_table.append(self.allocator.allocate_block())
                except NoBlocksError:
                    if not self.running:
                        break
                    victim = max(self.running, key=lambda s: s.arrival)
                    self._preempt(victim)
                    if victim is seq:
                        break
            if seq.state == SeqState.RUNNING:
                safe.append(seq)
        return safe

    def plan_pipelined_decode(
        self, seqs: list[Sequence], lag: dict
    ) -> Optional[dict]:
        """Plan the NEXT single-token decode step while one is in flight
        (the engine's ``_decode_pipeline``).

        ``lag`` maps id(seq) -> tokens sampled by in-flight steps but not
        yet applied to host state (one per step here). Sequences that
        finish inside the in-flight lag (max_tokens reached, max_model_len
        hit, or the block-table cap) are not rows of the next step, so a
        predicted finish never leaves an in-flight step writing KV into
        blocks a harvest-time ``finish()`` just freed. Returns None (flush
        the pipeline) on anything irregular: cancellation, deadline
        expiry, a non-RUNNING state, or block exhaustion. This path never
        preempts: the serial ``plan()`` handles pressure with nothing in
        flight.

        Returns {"seqs", "arrays", "src_idx", "offsets", "vmap"}: the next
        step's rows, its decode arrays (the token column is a placeholder:
        the engine chains it on the device from the in-flight step's
        sampled tokens via ``src_idx``), per-row seed offsets (= lags),
        and the one token each row will add.
        """
        now = time.monotonic()
        survivors: list[Sequence] = []
        for seq in seqs:
            if seq.state != SeqState.RUNNING:
                return None
            if seq.is_cancelled and seq.is_cancelled():
                return None
            if bool(seq.deadline) and now >= seq.deadline:
                return None
            gl = lag.get(id(seq), 0)
            if (
                seq.max_new_tokens is not None
                and seq.max_new_tokens - seq.generated <= gl
            ):
                continue  # finishes inside the in-flight step
            if self.max_model_len and seq.total_len + gl >= self.max_model_len:
                continue
            if len(seq.block_table) >= self.allocator.num_blocks - 1:
                continue  # should_finish's can't-grow-further clause
            survivors.append(seq)
        if not survivors:
            return None
        bs = self.block_size
        # block growth for the next step's KV write (the in-flight token's
        # slot): no preemption; rollback on exhaustion
        added: list[Sequence] = []
        ok = True
        for seq in survivors:
            needed = seq.blocks_needed(seq.total_len + lag.get(id(seq), 0) + 1, bs)
            while len(seq.block_table) < needed:
                try:
                    seq.block_table.append(self.allocator.allocate_block())
                    added.append(seq)
                except NoBlocksError:
                    ok = False
                    break
            if not ok:
                break
        if not ok:
            for seq in reversed(added):
                self.allocator.free_sequence([seq.block_table.pop()])
            return None
        old_row = {id(s): j for j, s in enumerate(seqs)}
        n = len(survivors)
        B = self._decode_batch(n)
        width = self._table_width(max(len(s.block_table) for s in survivors))
        positions = np.zeros((B, 1), np.int32)
        slot_mapping = np.zeros((B,), np.int32)
        tables = np.zeros((B, width), np.int32)
        ctx = np.zeros((B,), np.int32)
        src_idx = np.zeros((B,), np.int32)
        offsets = [0] * n
        vmap: dict[int, int] = {}
        for i, s in enumerate(survivors):
            gl = lag.get(id(s), 0)
            src_idx[i] = old_row[id(s)]
            pos = s.total_len - 1 + gl
            positions[i, 0] = pos
            slot_mapping[i] = s.block_table[pos // bs] * bs + pos % bs
            tables[i, : len(s.block_table)] = s.block_table
            ctx[i] = s.total_len + gl
            offsets[i] = gl
            vmap[id(s)] = 1
        arrays = {
            "tokens": np.zeros((B, 1), np.int32),  # device chain overrides
            "positions": positions,
            "slot_mapping": slot_mapping,
            "block_tables": tables,
            "context_lens": ctx,
            "last_token_idx": np.zeros((B,), np.int32),
        }
        return {
            "seqs": survivors,
            "arrays": arrays,
            "src_idx": src_idx,
            "offsets": offsets,
            "vmap": vmap,
        }

    def _preempt(self, victim: Sequence) -> None:
        log.warning("preempting %s (recompute)", victim.request_id)
        self.preemptions += 1
        self.running.remove(victim)
        self.allocator.free_sequence(victim.block_table)
        victim.block_table = []
        victim.num_computed = 0
        victim.num_cached_prompt = 0
        victim.committed_blocks = 0
        victim.state = SeqState.WAITING
        self.waiting.appendleft(victim)

    # -- post-step bookkeeping -------------------------------------------
    def append_token(self, seq: Sequence, token: int) -> None:
        seq.tokens.append(int(token))
        seq.generated += 1
        # the just-sampled token's KV is written only when it is fed on
        # the next step; counting it as computed would content-address a
        # block whose last slot is still garbage
        seq.num_computed = seq.total_len - 1
        self._commit_full_blocks(seq)

    def _commit_full_blocks(self, seq: Sequence) -> None:
        """Content-address newly completed, fully-computed blocks."""
        hashes = seq.tokens.sequence_hashes()
        n_complete_computed = min(
            seq.num_computed // self.block_size, len(seq.block_table), len(hashes)
        )
        for i in range(seq.committed_blocks, n_complete_computed):
            self.allocator.commit_block(seq.block_table[i], hashes[i])
        seq.committed_blocks = max(seq.committed_blocks, n_complete_computed)

    def should_finish(self, seq: Sequence) -> Optional[FinishReason]:
        if seq.max_new_tokens is not None and seq.generated >= seq.max_new_tokens:
            return FinishReason.LENGTH
        if self.max_model_len and seq.total_len >= self.max_model_len:
            return FinishReason.LENGTH
        if len(seq.block_table) >= self.allocator.num_blocks - 1:
            return FinishReason.LENGTH  # can't possibly grow further
        return None

    def finish(self, seq: Sequence, reason: FinishReason) -> None:
        if seq.state == SeqState.FINISHED:
            return
        seq.state = SeqState.FINISHED
        seq.finish_reason = reason
        if seq in self.running:
            self.running.remove(seq)
        if seq.block_table:
            self.allocator.free_sequence(seq.block_table)
            seq.block_table = []
        if self.on_finish is not None:
            self.on_finish(seq, reason)

    # -- step arrays (bucketed shapes, as the reference lays them out) ----
    def _table_width(self, max_blocks: int) -> int:
        """Block-table width for a step: the fixed serving cap when set
        (one shape), bucketed otherwise; growing past the cap degrades to
        a wider bucket rather than corrupting tables."""
        w = max(
            self.TABLE_BUCKET,
            -(-max_blocks // self.TABLE_BUCKET) * self.TABLE_BUCKET,
        )
        if self.table_width_pad is not None and w <= self.table_width_pad:
            return self.table_width_pad
        return w

    def _decode_batch(self, n: int) -> int:
        if self.decode_batch_small is not None and n <= self.decode_batch_small:
            return self.decode_batch_small
        if self.decode_batch_mid is not None and n <= self.decode_batch_mid:
            return self.decode_batch_mid
        b = next_bucket(n, self.BATCH_BUCKETS)
        if self.decode_batch_pad is not None and b <= self.decode_batch_pad:
            return self.decode_batch_pad
        return b

    def build_prefill_batch_arrays(
        self, works: list[PrefillWork]
    ) -> dict[str, np.ndarray]:
        """Fuse several sequences' prefill chunks into one [B, T] step
        (rows padded to the chunk bucket, batch padded to the batch
        bucket; pads write to the garbage slot 0 like decode pads)."""
        bs = self.block_size
        n = len(works)
        B = next_bucket(n, self.BATCH_BUCKETS)
        T = next_bucket(max(len(w.tokens) for w in works), self.CHUNK_BUCKETS)
        width = self._table_width(max(len(w.seq.block_table) for w in works))
        tokens = np.zeros((B, T), np.int32)
        positions = np.zeros((B, T), np.int32)
        slot_mapping = np.zeros((B * T,), np.int32)
        tables = np.zeros((B, width), np.int32)
        ctx = np.zeros((B,), np.int32)
        last_idx = np.zeros((B,), np.int32)
        for i, w in enumerate(works):
            t = len(w.tokens)
            tokens[i, :t] = w.tokens
            pos = np.arange(w.start_pos, w.start_pos + t)
            positions[i, :t] = pos
            table = np.asarray(w.seq.block_table, np.int32)
            slot_mapping[i * T : i * T + t] = table[pos // bs] * bs + pos % bs
            tables[i, : len(table)] = table
            ctx[i] = w.start_pos + t
            last_idx[i] = t - 1
        return {
            "tokens": tokens,
            "positions": positions,
            "slot_mapping": slot_mapping,
            "block_tables": tables,
            "context_lens": ctx,
            "last_token_idx": last_idx,
        }

    def build_decode_arrays(self, seqs: list[Sequence]) -> dict[str, np.ndarray]:
        bs = self.block_size
        B = self._decode_batch(len(seqs))
        width = self._table_width(max(len(s.block_table) for s in seqs))
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros((B, 1), np.int32)
        slot_mapping = np.zeros((B,), np.int32)
        tables = np.zeros((B, width), np.int32)
        ctx = np.zeros((B,), np.int32)
        for i, s in enumerate(seqs):
            tokens[i, 0] = s.tokens.last_token()
            pos = s.total_len - 1
            positions[i, 0] = pos
            slot_mapping[i] = s.block_table[pos // bs] * bs + pos % bs
            tables[i, : len(s.block_table)] = s.block_table
            ctx[i] = s.total_len
        return {
            "tokens": tokens,
            "positions": positions,
            "slot_mapping": slot_mapping,
            "block_tables": tables,
            "context_lens": ctx,
            "last_token_idx": np.zeros((B,), np.int32),
        }
