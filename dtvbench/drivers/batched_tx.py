"""One stream, L consecutive blocks per call through the program's
batched modulator, IQ left on the device.

Each call continues the stream from the previous call's tail.  The TS
comes from a pool of distinct seeded blocks made on the device, larger
than the card's L2, read in order.  The host may run ``in_flight`` calls
ahead of the device and no further.  After the window a seeded sample of
calls is checked against the reference, block for block.
"""

from __future__ import annotations

import torch

from dtvbench import compare, traffic, window


def run(ctx) -> window.Outcome:
    std, dev, t = ctx.std, ctx.device, ctx.workload["traffic"]
    L, P = t["blocks_per_call"], t["pool_blocks"]
    if P % L:
        raise ValueError("pool_blocks must be a multiple of blocks_per_call")
    pool = traffic.ts_blocks(P, std.BLOCK_BYTES, ctx.seed, "pool", dev)
    fn = _planted(ctx, std.batched(ctx.cfg, dev), L)
    ctx.mark("inputs")

    def inputs(c):
        s = c * L
        prev = pool[(s - 1) % P, -std.HALO_BYTES:] if s else None
        return pool[s % P:s % P + L], prev, s

    for c in range(t["warmup_calls"]):
        fn(*inputs(c))
        ctx.mark(f"warm-up call {c}")
    sample = traffic.Sample(ctx.workload["check"]["calls"], ctx.seed, "check")
    kept = {}
    events = []

    def call(i):
        c = t["warmup_calls"] + i
        out = fn(*inputs(c))
        if dev.type == "cuda":
            events.append(torch.cuda.Event())
            events[-1].record()
        slot = sample.offer()
        if slot is not None:
            kept[slot] = (c, out)
        return L * std.BLOCK_SAMPLES

    def wait(i):
        if dev.type == "cuda" and i >= t["in_flight"]:
            events[i - t["in_flight"]].synchronize()

    rec = window.measure(ctx.seconds, call, dev, wait=wait, **ctx.trace_args)
    peak = ctx.memory_peak()
    checked = []
    for c, out in kept.values():
        ts, prev, s = inputs(c)
        checked.append((s, ts.clone(), None if prev is None else prev.clone(),
                        out))
    del pool, kept, events, fn
    ctx.release_program()
    errs = [compare.iq_err(out, std.reference(ts, prev, s))
            for s, ts, prev, out in checked]
    limit = ctx.workload["check"]["limits"]["iq_err"]
    return window.Outcome(
        record=rec, checks={"iq_err": (max(errs), limit)},
        attempted=rec.calls, failed=sum(e > limit for e in errs),
        memory_peak_bytes=peak, work={"blocks_per_call": L})


def _planted(ctx, fn, L):
    """The program's call, or (for the control and fault runs, never the
    benchmark's) the reference in its place or the call broken."""
    if ctx.plant is None:
        return fn
    std = ctx.std
    if ctx.plant == "control":
        return lambda ts, prev, s: std.reference(
            ts, prev, s, "bfloat16").to(torch.complex64).reshape(L, -1)
    if ctx.plant == "state":
        return lambda ts, prev, s: fn(ts, None, 0)
    if ctx.plant == "half":
        def half(ts, prev, s):
            out = fn(ts, prev, s)
            out[L // 2:] = 0
            return out
        return half
    if ctx.plant == "altered":
        def altered(ts, prev, s):
            ts = ts.clone()
            ts[0, 1000] ^= 1
            return fn(ts, prev, s)
        return altered
    raise ValueError(f"no plant {ctx.plant!r} for batched_tx")
