"""The streaming-engine abstraction: one request in, an async stream of
responses out, with per-request cooperative cancellation (graceful
``stop`` vs immediate ``kill``). The port's own copy of the reference's
``Context``/``AsyncEngine``."""

from __future__ import annotations

import abc
import asyncio
import time
import uuid
from typing import AsyncIterator, Generic, Optional, TypeVar

Req = TypeVar("Req")
Resp = TypeVar("Resp")


class Context:
    """Per-request control: an id, cooperative cancellation (graceful
    ``stop_generating`` or immediate ``kill``) and an optional deadline
    (a ``time.monotonic()`` instant)."""

    def __init__(self, id: Optional[str] = None):
        self.id = id or uuid.uuid4().hex
        self.deadline: Optional[float] = None
        self._stop = asyncio.Event()
        self._kill = asyncio.Event()

    def set_deadline_ms(self, budget_ms: Optional[float]) -> None:
        """Arm (or clear, with None) a deadline ``budget_ms`` from now."""
        self.deadline = (
            time.monotonic() + budget_ms / 1e3
            if budget_ms is not None else None
        )

    def stop_generating(self) -> None:
        self._stop.set()

    def kill(self) -> None:
        self._stop.set()
        self._kill.set()

    @property
    def is_stopped(self) -> bool:
        return self._stop.is_set()

    @property
    def is_killed(self) -> bool:
        return self._kill.is_set()


EngineStream = AsyncIterator[Resp]


class AsyncEngine(abc.ABC, Generic[Req, Resp]):
    """A streaming engine: one request in, an async stream of responses out."""

    @abc.abstractmethod
    def generate(self, request: Req, context: Context) -> EngineStream:
        """Returns an async iterator of responses. Implementations should
        poll ``context.is_stopped`` between items and terminate early."""
