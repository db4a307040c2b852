"""Device timing with CUDA events.

Torch CUDA ops return before the device finishes, so a host clock without a
synchronize measures the enqueue.  These helpers record CUDA events around
the timed launches and synchronize before reading them.  Host-side work the
caller does after a launch (such as ``cplx.rails_to_np``) is not part of the
timed region unless the timed function does it.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def elapsed_s(run: Callable[[], object], device: torch.device) -> float:
    """Seconds from the call of ``run()`` until ``device`` has finished
    what it launched.  On a CUDA device: two events recorded on the
    current stream around it, read after a synchronize (a synchronize
    first, so no earlier work enters the window); the host's gaps between
    launches count, as they do for a caller who waits for the result.  On
    the CPU, whose ops finish before they return: the host clock."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / 1e3
    if device.type == "cpu":
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    raise ValueError(f"cannot time on {device}")


def _current_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def time_cuda(fn: Callable[[], object], iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call of ``fn()`` over ``iters`` calls,
    after ``warmup`` untimed calls."""
    dev = _current_cuda()
    for _ in range(warmup):
        fn()

    def timed():
        for _ in range(iters):
            fn()
    return elapsed_s(timed, dev) * 1e3 / iters


def timed_stream(fn: Callable, inputs: Sequence, states: list,
                 warmup: int = 1) -> float:
    """Run ``out, states[s] = fn(inputs[i], states[s])`` round-robin over
    ``len(states)`` streams, one distinct input per launch, and return the
    device seconds of every round after the first ``warmup`` rounds.

    The serving shape of ``bench.py``'s J.83B metric: independent streams
    multiplexed on one device.  ``len(inputs)`` must be a multiple of
    ``len(states)`` and leave at least one timed round.
    """
    dev = _current_cuda()
    n_streams = len(states)
    if len(inputs) % n_streams or len(inputs) // n_streams <= warmup:
        raise ValueError("inputs must fill whole rounds, with at least one "
                         "round after the warm-up")
    it = iter(inputs)
    for _ in range(warmup):
        for s in range(n_streams):
            _, states[s] = fn(next(it), states[s])

    def timed():
        for i, x in enumerate(it):
            s = i % n_streams
            _, states[s] = fn(x, states[s])
    return elapsed_s(timed, dev)
