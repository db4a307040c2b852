"""Device timing with CUDA events.

Torch CUDA ops return before the device finishes, so a host clock without a
synchronize measures the enqueue.  These helpers record CUDA events around
the timed launches and synchronize before reading them.  Host-side work the
caller does after a launch (such as ``cplx.rails_to_np``) is not part of the
timed region unless the timed function does it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def time_cuda(fn: Callable[[], object], iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call of ``fn()`` over ``iters`` calls,
    after ``warmup`` untimed calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_stream(fn: Callable, inputs: Sequence, states: list,
                 warmup: int = 1) -> float:
    """Run ``out, states[s] = fn(inputs[i], states[s])`` round-robin over
    ``len(states)`` streams, one distinct input per launch, and return the
    device seconds of every round after the first ``warmup`` rounds.

    The serving shape of ``bench.py``'s J.83B metric: independent streams
    multiplexed on one device.  ``len(inputs)`` must be a multiple of
    ``len(states)`` and leave at least one timed round.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("timed_stream needs a CUDA device")
    n_streams = len(states)
    if len(inputs) % n_streams or len(inputs) // n_streams <= warmup:
        raise ValueError("inputs must fill whole rounds, with at least one "
                         "round after the warm-up")
    it = iter(inputs)
    for _ in range(warmup):
        for s in range(n_streams):
            _, states[s] = fn(next(it), states[s])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i, x in enumerate(it):
        s = i % n_streams
        _, states[s] = fn(x, states[s])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3
