"""Staging host IQ onto the card: a ring of pinned chunks, filled by a pool
of host threads, each chunk copied to the card as soon as it is filled.

A pageable array reaches the card through one host thread's memcpy and
then the copy, in series.  Here the array is cut into chunks (``chunk_plan``).
A pool of ``fill_threads()`` threads copies each chunk into a free slot of a
ring of pinned host buffers (``np.copyto``, which releases the GIL, so the
fills run in parallel); as each fill ends, the calling thread issues that
chunk's copy to the card on the ring's copy stream and records the slot's
event.  A slot is filled again only once its event has completed, so the
fill of one chunk overlaps the copies of those before it.

Every call copies every byte of its input, and has read all of it when it
returns: the caller may overwrite its array at once.  Nothing is pinned in
place and nothing is kept per input.  Each CUDA device has one ring, with
its slots, events, copy stream and pool, for the life of the process.
"""

from __future__ import annotations

import collections
import functools
import os
import threading
from concurrent import futures

import numpy as np
import torch

from dtv_utils_torch.utils.trace import span

CHUNK_BYTES = 4 << 20       # one slot
SLOTS = 16
MAX_THREADS = 8             # the fill's GB/s levels off by here (PERF.md)


def chunk_plan(n: int, chunk: int) -> list[tuple[int, int]]:
    """The ``[a, b)`` bounds of ``n`` elements cut into chunks of ``chunk``
    elements, in order; the last chunk may be shorter."""
    return [(a, min(a + chunk, n)) for a in range(0, n, chunk)]


def fill_threads() -> int:
    """The CPUs this process may run on, at most ``MAX_THREADS``."""
    return min(len(os.sched_getaffinity(0)), MAX_THREADS)


def _fill(dst: np.ndarray, src: np.ndarray, pending) -> None:
    # a query holds the GIL; a wait gives it up and takes it back
    if pending is not None and not pending.query():
        pending.synchronize()
    with span("dtv.stream.fill"):
        np.copyto(dst, src)


class Ring:
    """Host slots of one chunk each and the pool of threads that fills
    them; ``run`` passes one array through them."""

    def __init__(self, slots: list[np.ndarray], threads: int):
        self.slots = slots
        # per slot, what has to complete before the slot is filled again
        self._pending: list = [None] * len(slots)
        self._pool = futures.ThreadPoolExecutor(
            threads, thread_name_prefix="dtv-stage")
        self._lock = threading.Lock()

    def run(self, src: np.ndarray, send) -> None:
        """Pass the 1-D ``src`` through the slots.  Chunk k is filled into
        slot ``k % len(slots)`` on the pool; once its fill has ended,
        ``send(slot, a, b)`` is called on this thread, in chunk order, to
        hand on ``slots[slot][:b - a]``, which then holds ``src[a:b]``.
        ``send`` returns what has to complete (``.query()``,
        ``.synchronize()``) before that slot is filled again, or None.
        Returns when every fill has ended."""
        n_slots = len(self.slots)
        plan = chunk_plan(src.shape[0], self.slots[0].shape[0])
        with self._lock:
            fills = collections.deque()

            def fill(k):
                s, (a, b) = k % n_slots, plan[k]
                fills.append(self._pool.submit(
                    _fill, self.slots[s][:b - a], src[a:b], self._pending[s]))

            try:
                for k in range(min(n_slots, len(plan))):
                    fill(k)
                for k, (a, b) in enumerate(plan):
                    fills.popleft().result()
                    self._pending[k % n_slots] = send(k % n_slots, a, b)
                    if k + n_slots < len(plan):
                        fill(k + n_slots)
            finally:
                # a failed call leaves no fill writing into the slots
                futures.wait(fills)

    def close(self) -> None:
        self._pool.shutdown()


class CudaStager:
    """One CUDA device's ring: ``slots`` pinned slots of ``chunk``
    complex64 samples, one event per slot and a copy stream."""

    def __init__(self, device: torch.device, *,
                 chunk: int = CHUNK_BYTES // 8, slots: int = SLOTS,
                 threads: int | None = None):
        self.device = device
        with torch.cuda.device(device):
            self._pinned = [torch.empty(chunk, dtype=torch.complex64,
                                        pin_memory=True)
                            for _ in range(slots)]
            self._events = [torch.cuda.Event() for _ in range(slots)]
            self.stream = torch.cuda.Stream(device)
        self.ring = Ring([p.numpy() for p in self._pinned],
                         threads or fill_threads())

    def __call__(self, src: np.ndarray) -> torch.Tensor:
        """1-D complex64 ``src`` → a new tensor on the device with its
        values, ordered before later work on the current stream."""
        current = torch.cuda.current_stream(self.device)
        out = torch.empty(src.shape[0], dtype=torch.complex64,
                          device=self.device)
        # ``out`` may reuse memory that work queued before still uses
        self.stream.wait_stream(current)

        def send(s, a, b):
            out[a:b].copy_(self._pinned[s][:b - a], non_blocking=True)
            self._events[s].record(self.stream)
            return self._events[s]

        with torch.cuda.stream(self.stream):
            self.ring.run(src, send)
        current.wait_stream(self.stream)
        return out


@functools.lru_cache(maxsize=None)
def _stager(device: torch.device) -> CudaStager:
    return CudaStager(device)


def to_device(src: np.ndarray, device: torch.device) -> torch.Tensor:
    """1-D complex64 host ``src`` → a new flat tensor on CUDA ``device``,
    through that device's ring."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _stager(device)(src)
