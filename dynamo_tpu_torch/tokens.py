"""Token blocks and chained content hashing: the part of the reference's
token machinery the scheduler and allocator need.

Block hashes are xxh3-64 over the block's token ids as little-endian u32;
sequence hashes chain ``seq_hash[i] = xxh3_64(u64le(seq_hash[i-1]) ||
u64le(block_hash[i]))``, the first block seeded by the salt alone. The
values are identical to the reference's, so both engines address the
same prefix blocks by the same hashes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import xxhash

DEFAULT_SALT: int = 0x5D1_7B0_057


def compute_block_hash(tokens: Sequence[int] | np.ndarray, salt: int = DEFAULT_SALT) -> int:
    """Content hash of one block of token ids (u32 little-endian buffer)."""
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.uint32))
    return xxhash.xxh3_64_intdigest(arr.tobytes(), seed=salt)


def chain_hash(parent_seq_hash: int | None, block_hash: int, salt: int = DEFAULT_SALT) -> int:
    """Chained sequence hash: parent ∘ block → new sequence hash."""
    if parent_seq_hash is None:
        return xxhash.xxh3_64_intdigest(struct.pack("<Q", block_hash), seed=salt)
    return xxhash.xxh3_64_intdigest(
        struct.pack("<QQ", parent_seq_hash, block_hash), seed=salt
    )


@dataclass(frozen=True)
class TokenBlock:
    """An immutable, complete block of ``block_size`` tokens."""

    tokens: tuple[int, ...]
    block_hash: int
    sequence_hash: int
    parent_sequence_hash: int | None


@dataclass
class PartialTokenBlock:
    """The mutable tail block of a sequence; commits into a TokenBlock."""

    block_size: int
    salt: int = DEFAULT_SALT
    tokens: list[int] = field(default_factory=list)
    parent_sequence_hash: int | None = None

    def push(self, token: int) -> TokenBlock | None:
        """Append one token; returns a completed TokenBlock when full."""
        self.tokens.append(int(token))
        if len(self.tokens) == self.block_size:
            bh = compute_block_hash(self.tokens, self.salt)
            sh = chain_hash(self.parent_sequence_hash, bh, self.salt)
            block = TokenBlock(
                tokens=tuple(self.tokens),
                block_hash=bh,
                sequence_hash=sh,
                parent_sequence_hash=self.parent_sequence_hash,
            )
            self.tokens = []
            self.parent_sequence_hash = sh
            return block
        return None

    def __len__(self) -> int:
        return len(self.tokens)


class TokenBlockSequence:
    """A token sequence chunked into hashed blocks plus a partial tail."""

    def __init__(
        self,
        tokens: Sequence[int] | None = None,
        block_size: int = 16,
        salt: int = DEFAULT_SALT,
    ):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self.salt = salt
        self.blocks: list[TokenBlock] = []
        self.partial = PartialTokenBlock(block_size=block_size, salt=salt)
        if tokens is not None:
            self.extend(tokens)

    def append(self, token: int) -> TokenBlock | None:
        """Append a single token; returns the newly completed block, if any."""
        block = self.partial.push(token)
        if block is not None:
            self.blocks.append(block)
        return block

    def extend(self, tokens: Sequence[int]) -> list[TokenBlock]:
        """Append many tokens; returns all newly completed blocks."""
        new_blocks: list[TokenBlock] = []
        for t in tokens:
            b = self.append(t)
            if b is not None:
                new_blocks.append(b)
        return new_blocks

    def last_token(self) -> int:
        if self.partial.tokens:
            return self.partial.tokens[-1]
        if self.blocks:
            return self.blocks[-1].tokens[-1]
        raise IndexError("empty sequence has no last token")

    def all_tokens(self) -> list[int]:
        out: list[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self.partial.tokens)
        return out

    def block_hashes(self) -> list[int]:
        return [b.block_hash for b in self.blocks]

    def sequence_hashes(self) -> list[int]:
        return [b.sequence_hash for b in self.blocks]

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self.partial)
