"""Pieces the port's tools share: the default output directory, and a
producer thread that builds a tool's next batches on the host while the
card runs the current step."""
from __future__ import annotations

import os
import queue
import tempfile
import threading
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")


def default_out(name: str) -> str:
    """``<temp dir>/name``: the JAX tools' ``/tmp/<name>`` under ``TMPDIR``."""
    return os.path.join(tempfile.gettempdir(), name)


def prefetched(make: Callable[[], T], n: int, depth: int = 4) -> Iterator[T]:
    """``make()`` called ``n`` times, in order, on one producer thread that
    keeps up to ``depth`` results ahead of the consumer: the same values in
    the same order as calling it inline (a generator that ``make`` draws
    from is touched by that thread alone). numpy's bulk draws and array
    operations release the GIL, so the batches are built while the main
    thread launches the step. An exception in ``make`` is raised in the
    consumer; leaving the loop early stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def work():
        try:
            for _ in range(n):
                if stop.is_set():
                    return
                q.put((True, make()))
        except BaseException as e:  # handed to the consumer
            q.put((False, e))

    t = threading.Thread(target=work, daemon=True)
    t.start()
    try:
        for _ in range(n):
            ok, value = q.get()
            if not ok:
                raise value
            yield value
    finally:
        stop.set()
        while t.is_alive():  # let a blocked put finish so the thread ends
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(0.01)
