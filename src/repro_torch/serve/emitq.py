"""Background detokenize/emit queue (a copy of ``repro.serve.emitq``).

The engine's harvest loop banks raw emissions (token ids, frame indices)
into ``req.out`` — a cheap host append.  Everything downstream of that —
detokenization, delivery to a consumer callback — is Python work that has
no business sitting between two device steps.  :class:`AsyncEmitter` moves
it onto a daemon worker thread: harvest pushes ``(req, item)`` and returns
immediately; the worker detokenizes and appends to ``req.detok`` (and fires
the optional ``on_emit`` callback) in arrival order.

Per-request order is preserved (single worker, FIFO queue).  ``flush()``
blocks until everything pushed so far is delivered — tests and drain paths
call it to make the asynchrony deterministic.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


def default_detok(item) -> str:
    """Stand-in detokenizer: stable printable piece per id (no tokenizer
    dependency in-container; launchers swap in a real one)."""
    return f"<{int(item)}>"


class AsyncEmitter:
    """Single-worker background emit queue.

    push(req, item): enqueue one emission; never blocks the caller.
    flush(): wait until the queue is empty and in-flight work is done.
    close(): flush and stop the worker (idempotent).
    """

    def __init__(self, detok: Optional[Callable] = None,
                 on_emit: Optional[Callable] = None):
        self._detok = detok or default_detok
        self._on_emit = on_emit
        self._q: "queue.Queue" = queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        self._closed = False
        self.emitted = 0
        self.errors = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="repro-emitq")
        self._worker.start()

    def push(self, req, item) -> None:
        if self._closed:
            raise RuntimeError("emitter closed")
        self._idle.clear()
        self._q.put((req, item))

    def _run(self) -> None:
        while True:
            got = self._q.get()
            if got is None:
                self._q.task_done()
                return
            req, item = got
            try:
                piece = self._detok(item)
                if not hasattr(req, "detok"):
                    req.detok = []
                req.detok.append(piece)
                if self._on_emit is not None:
                    self._on_emit(req, piece)
                self.emitted += 1
            except Exception:   # emit failures must never kill the worker
                self.errors += 1
            finally:
                self._q.task_done()
                if self._q.unfinished_tasks == 0:
                    self._idle.set()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until all pushed emissions are delivered."""
        return self._idle.wait(timeout=timeout)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.flush()
        self._q.put(None)
        self._worker.join(timeout=5.0)
