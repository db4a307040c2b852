"""C channels round-robin, one block per call each, through the program's
served path: host TS in, host IQ out, each channel's state carried from
its previous call.

Each channel reads its own pool of distinct seeded blocks, in order.
After the window one seeded call of each channel is checked against the
reference, which derives its state from the channel's previous block:
so the check covers the channel's continuity as well as the block.
"""

from __future__ import annotations

import torch

from dtvbench import compare, traffic, window


def run(ctx) -> window.Outcome:
    std, dev, t = ctx.std, ctx.device, ctx.workload["traffic"]
    C, P = t["channels"], t["pool_blocks_per_channel"]
    pools = traffic.ts_blocks(C * P, std.BLOCK_BYTES, ctx.seed, "pool",
                              dev).reshape(C, P, -1).cpu().numpy()
    streams = [_planted(ctx, std.Stream(ctx.cfg, dev)) for _ in range(C)]

    def issue(c):
        ch, b = c % C, c // C
        return ch, b, streams[ch](pools[ch, b % P], b)

    warm = t["warmup_calls_per_channel"] * C
    ctx.mark("inputs")
    for c in range(warm):
        issue(c)
        ctx.mark(f"warm-up call {c}")
    samples = [traffic.Sample(1, ctx.seed, f"check{ch}") for ch in range(C)]
    kept = {}

    def call(i):
        ch, b, iq = issue(warm + i)
        if samples[ch].offer() is not None:
            kept[ch] = (b, iq)
        return iq.shape[0]

    rec = window.measure(ctx.seconds, call, dev, **ctx.trace_args)
    peak = ctx.memory_peak()
    del streams
    ctx.release_program()
    errs = []
    for ch, (b, iq) in sorted(kept.items()):
        ts = torch.from_numpy(pools[ch, b % P]).to(dev)
        prev = torch.from_numpy(
            pools[ch, (b - 1) % P, -std.HALO_BYTES:]).to(dev)
        want = std.reference(ts, prev, b)
        errs.append(compare.iq_err(torch.from_numpy(iq).to(dev), want))
    limit = ctx.workload["check"]["limits"]["iq_err"]
    return window.Outcome(
        record=rec, checks={"iq_err": (max(errs), limit)},
        attempted=rec.calls, failed=sum(e > limit for e in errs),
        memory_peak_bytes=peak, work={"blocks_per_call": 1})


class _Reference:
    """The reference in the program's place (the control): host TS in,
    host complex64 IQ out, bfloat16 inside; its state is derived from the
    channel's previous block, which it keeps."""

    def __init__(self, std, device):
        self.std, self.dev, self.prev = std, device, None

    def __call__(self, ts, b):
        x = torch.from_numpy(ts).to(self.dev)
        iq = self.std.reference(x, self.prev, b, "bfloat16")
        self.prev = x[-self.std.HALO_BYTES:]
        return iq.to(torch.complex64).cpu().numpy()


def _planted(ctx, stream):
    """``fn(ts host block, block index)`` → host IQ: the program's
    channel, or (for the control and fault runs, never the benchmark's)
    the reference in its place or the channel broken."""
    if ctx.plant is None:
        return lambda ts, b: stream(ts)
    if ctx.plant == "control":
        return _Reference(ctx.std, ctx.device)
    if ctx.plant == "state":
        def fresh(ts, b):
            stream.state = None
            return stream(ts)
        return fresh
    if ctx.plant == "half":
        def half(ts, b):
            iq = stream(ts)
            iq[iq.shape[0] // 2:] = 0
            return iq
        return half
    if ctx.plant == "altered":
        def altered(ts, b):
            ts = ts.copy()
            ts[1000] ^= 1
            return stream(ts)
        return altered
    raise ValueError(f"no plant {ctx.plant!r} for stream_tx")
