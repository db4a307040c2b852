"""The measured window: calls one after the other for ``seconds`` of the
host's clock, then a synchronise; the host span of every call; and, in a
traced run, a profiler session over a bounded number of steady calls
inside the window.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import torch

from dtvbench import trace as tr


@dataclass
class Record:
    t0: float                       # perf_counter at the first timed call
    t1: float = 0.0                 # after the closing synchronise
    calls: int = 0
    samples: int = 0                # IQ samples made or taken in
    spans: list[float] = field(default_factory=list)   # host s per call
    profiled: set[int] = field(default_factory=set)    # calls traced
    summary: tr.Summary | None = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def unprofiled_spans(self) -> list[float]:
        return [s for i, s in enumerate(self.spans) if i not in self.profiled]


@dataclass
class Outcome:
    """What a driver hands back: the window, the numbers compared with
    their limits, the answers attempted and found wrong, the device's
    peak memory in the window, readings beside the check (logged, not
    compared), and the work of one call."""
    record: Record
    checks: dict[str, tuple[float, float]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    info: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)


def synchronizer(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def measure(seconds: float, call, device: torch.device, *, wait=None,
            trace_calls: int = 0, trace_after_s: float = 0.0) -> Record:
    """Run ``call(i)`` (returning the IQ samples it made or took) for
    i = 0, 1, … until ``seconds`` have passed, then synchronise the
    device; ``wait(i)``, outside the call's span, may hold call i back.
    With ``trace_calls``, the first call after ``trace_after_s`` starts
    the profiler (that call fills its buffers and is not read), and the
    next ``trace_calls`` calls run inside one ``WINDOW`` range between
    two synchronises; the window does not close before they have run."""
    sync = synchronizer(device)
    # set-up's objects leave the collector's view: a full collection over
    # them inside the window would stall a call for tens of ms
    gc.collect()
    gc.freeze()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    rec = Record(t0=time.perf_counter())
    prof = rng = None
    first = None
    i = 0
    while True:
        now = time.perf_counter()
        traced = not trace_calls or rec.summary is not None
        if now - rec.t0 >= seconds and traced:
            break
        if trace_calls and first is None and now - rec.t0 >= trace_after_s:
            sync()
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            first = i + 1
        if wait is not None:
            wait(i)
        a = time.perf_counter()
        n = call(i)
        rec.spans.append(time.perf_counter() - a)
        rec.samples += n
        if prof is not None:
            rec.profiled.add(i)
            if i + 1 == first:
                sync()
                rng = torch.profiler.record_function(tr.WINDOW)
                rng.__enter__()
            elif i + 1 == first + trace_calls:
                sync()
                rng.__exit__(None, None, None)
                prof.stop()
                rec.summary = tr.summarize(prof, trace_calls)
                prof = None
        i += 1
    sync()
    rec.t1 = time.perf_counter()
    rec.calls = i
    gc.unfreeze()
    return rec
