"""JSONL event sink, the flight recorder (DESIGN.md §15, §16), after
``repro.obs.sink``.

One event per line — ``{"event": <name>, "ts": <unix seconds>, ...fields}``
— appended so concurrent writers interleave without clobbering each other.
The resilience events of a guarded resampler reach it through
``resilience.guards.record_resilience_events(sink)``; anything that reads
the file gets an ordered, replayable record of what a run actually did.

Crash consistency (§16): the sink may buffer (``buffer_size > 1``) to
amortise the open/append per event, but a flight recorder that loses its
tail on a crash is useless — so every sink registers an ``atexit`` flush,
is a context manager (``close()`` on exit, normal OR abnormal), and
``flush()`` is idempotent/re-entrant.  The default ``buffer_size=1``
keeps the historical write-through behaviour byte for byte.
"""

from __future__ import annotations

import atexit
import json
import os
import time


class JsonlSink:
    """Append-only JSONL event writer.  Values must be JSON-serialisable;
    non-serialisable values are stringified rather than dropped, so an odd
    tensor scalar can never kill a run.

    ``buffer_size=1`` (default) writes through on every ``emit``;
    larger sizes batch lines and flush when the buffer fills, on
    ``flush()``/``close()``/context exit, and at interpreter exit
    (``atexit``) — abnormal exits keep their recorded tail.
    """

    def __init__(self, path: str, *, buffer_size: int = 1):
        if isinstance(buffer_size, bool) or not isinstance(buffer_size, int) \
                or buffer_size < 1:
            raise ValueError(
                f"JsonlSink.buffer_size must be a positive int; got {buffer_size!r}"
            )
        self.path = path
        self.buffer_size = buffer_size
        self._buffer: list = []
        self._closed = False
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        atexit.register(self.flush)

    def emit(self, event: str, **fields) -> None:
        if self._closed:
            raise ValueError(f"JsonlSink({self.path!r}) is closed")
        record = {"event": event, "ts": round(time.time(), 3)}
        for k, v in fields.items():
            try:
                json.dumps(v)
            except (TypeError, ValueError):
                v = str(v)
            record[k] = v
        self._buffer.append(json.dumps(record))
        if len(self._buffer) >= self.buffer_size:
            self.flush()

    def flush(self) -> None:
        """Drain the buffer to disk (one append, fsync'd).  Idempotent —
        safe from ``atexit`` after an explicit ``close()``."""
        if not self._buffer:
            return
        lines, self._buffer = self._buffer, []
        with open(self.path, "a") as f:
            f.write("\n".join(lines) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def close(self) -> None:
        """Flush and seal the sink; further ``emit`` calls raise."""
        self.flush()
        self._closed = True

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # Abnormal exit included: the recorded tail always lands on disk.
        self.close()
