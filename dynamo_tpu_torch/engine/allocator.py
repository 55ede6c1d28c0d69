"""Paged KV block allocator with content-addressed prefix reuse (the
port's copy of the reference allocator).

Ref-counted active blocks plus an LRU-ordered free pool that keeps
complete blocks addressable by their sequence hash until evicted.

Block 0 is reserved as the padding/garbage block: padded entries of block
tables and slot mappings point at it, so masked rows have somewhere
harmless to read and write.

Emits KV events (stored/removed) through ``on_event``.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

KvEventFn = Callable[[str, list[int], list[int]], None]
# signature: (op="stored"|"removed", block_hashes, parent_info) — see publisher


@dataclass
class _Block:
    id: int
    ref_count: int = 0
    seq_hash: Optional[int] = None  # set once the block's content is complete


class NoBlocksError(RuntimeError):
    pass


class BlockAllocator:
    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        enable_prefix_caching: bool = True,
        on_event: Optional[KvEventFn] = None,
    ):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.enable_prefix_caching = enable_prefix_caching
        self.on_event = on_event
        self._blocks = [_Block(i) for i in range(num_blocks)]
        # free blocks in LRU order (least-recently-freed first = evict first)
        self._free: OrderedDict[int, None] = OrderedDict(
            (i, None) for i in range(1, num_blocks)
        )
        # seq_hash -> block id, for complete cached blocks (active or free)
        self._hash_index: dict[int, int] = {}
        # free blocks still holding content-addressed KV (maintained
        # incrementally: O(free) scans per scrape would defeat the
        # point of a per-step gauge)
        self._cached_free = 0

    # -- introspection ----------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached_free(self) -> int:
        """Free blocks whose content is still content-addressed — the
        prefix cache's evictable working set (observability)."""
        return self._cached_free

    @property
    def usage(self) -> float:
        usable = self.num_blocks - 1
        return 1.0 - len(self._free) / usable if usable else 1.0

    def lookup_block(self, seq_hash: int) -> Optional[int]:
        """Device block currently holding this content (if cached)."""
        return self._hash_index.get(seq_hash)

    def match_prefix(self, seq_hashes: list[int]) -> int:
        """How many leading complete blocks are cached (no allocation)."""
        n = 0
        for h in seq_hashes:
            if h in self._hash_index:
                n += 1
            else:
                break
        return n

    def free_need(self, seq_hashes: list[int], n_total: int) -> int:
        """How many blocks allocating this prompt would take from the
        FREE pool (no allocation): fresh blocks plus matched prefix
        blocks that are currently cached-free. Matched blocks pinned by
        other sequences cost the free pool nothing — charging them
        would make admission stall on exactly the shared-prefix
        workloads prefix caching exists for."""
        need = n_total
        if self.enable_prefix_caching:
            for h in seq_hashes:
                bid = self._hash_index.get(h)
                if bid is None:
                    break
                if bid not in self._free:
                    need -= 1  # actively shared: already pinned elsewhere
        return max(0, need)

    # -- allocation -------------------------------------------------------
    def allocate_prefix(self, seq_hashes: list[int]) -> tuple[list[int], int]:
        """Allocate blocks for a prompt: reuse the cached complete-block
        prefix, fresh-allocate the rest. Returns (block_ids, cached_blocks).

        Raises NoBlocksError (allocating nothing) if capacity is short.
        """
        reused: list[int] = []
        if self.enable_prefix_caching:
            for h in seq_hashes:
                bid = self._hash_index.get(h)
                if bid is None:
                    break
                reused.append(bid)
        # pin reused blocks FIRST so _pop_free can't evict them from the
        # free/cached list while we allocate the fresh tail
        for bid in reused:
            self._ref(bid)
        need_fresh = len(seq_hashes) - len(reused)
        if need_fresh > len(self._free):
            self.free_sequence(reused)  # rollback pins
            raise NoBlocksError(
                f"need {need_fresh} fresh blocks, have {len(self._free)}"
            )
        fresh = [self._pop_free() for _ in range(need_fresh)]
        return reused + fresh, len(reused)

    def allocate_block(self) -> int:
        """One fresh block (decode growth)."""
        if not self._free:
            raise NoBlocksError("no free blocks")
        return self._pop_free()

    def commit_block(self, block_id: int, seq_hash: int) -> None:
        """Mark a block's content complete + content-addressed."""
        if not self.enable_prefix_caching:
            return
        block = self._blocks[block_id]
        if block.seq_hash == seq_hash:
            return  # already committed: no duplicate event
        old = self._hash_index.get(seq_hash)
        if old is not None and old != block_id:
            # duplicate content computed concurrently; keep the existing entry
            return
        block.seq_hash = seq_hash
        self._hash_index[seq_hash] = block_id
        if block_id in self._free:  # defensive: commits normally target
            self._cached_free += 1  # active blocks
        if self.on_event:
            self.on_event("stored", [seq_hash], [block_id])

    def free_sequence(self, block_ids: list[int]) -> None:
        """Release a sequence's blocks. Hashed blocks stay cached (LRU);
        unhashed blocks are recycled immediately."""
        for bid in block_ids:
            if bid == 0:
                continue
            block = self._blocks[bid]
            block.ref_count -= 1
            if block.ref_count > 0:
                continue
            if block.seq_hash is None:
                self._free[bid] = None  # plain free
                self._free.move_to_end(bid, last=False)  # recycle soon
            else:
                self._free[bid] = None  # cached-free: evict LRU-last
                self._free.move_to_end(bid, last=True)
                self._cached_free += 1

    # -- internals --------------------------------------------------------
    def _ref(self, bid: int) -> None:
        block = self._blocks[bid]
        if block.ref_count == 0:
            if self._free.pop(bid, -1) is None and block.seq_hash is not None:
                self._cached_free -= 1
        block.ref_count += 1

    def _evictable_count(self) -> int:
        return len(self._free)

    def _pop_free(self) -> int:
        if not self._free:
            raise NoBlocksError("no free blocks")
        bid, _ = self._free.popitem(last=False)
        block = self._blocks[bid]
        if block.seq_hash is not None:
            # evicting cached content
            self._cached_free -= 1
            self._hash_index.pop(block.seq_hash, None)
            if self.on_event:
                self.on_event("removed", [block.seq_hash], [bid])
            block.seq_hash = None
        block.ref_count = 1
        return bid
