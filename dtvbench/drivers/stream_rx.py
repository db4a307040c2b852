"""Receive of noisy captures: L blocks per call as host complex64 IQ into
the program's receiver, host TS and health flags out.

Set-up modulates one chunk of seeded TS with the reference, from the
stream's start, and adds ``noise_draws`` seeded draws of white Gaussian
noise at ``snr_db`` below its mean power, on the device; the window
sends the captures in turn.  Of each draw's calls, ``calls_per_draw``
drawn from the seed are checked: their TS byte for byte against what was
sent (a call must return at least ``min_packets`` packets), and the
output of the stage whose precision the configuration states (the
standard's ``demap_tap``) against the reference's demap of the same
capture.  Every call's health flags are read after the window.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from dtvbench import compare, traffic, window


def captures(std, t: dict, seed: int, device) -> tuple[np.ndarray, list]:
    """(sent TS, [host complex64 captures]) of one run."""
    ts = traffic.ts_blocks(t["blocks_per_call"], std.BLOCK_BYTES, seed,
                           "capture", device).reshape(-1)
    clean = std.capture(ts)
    power = float(clean.abs().square().mean())
    sigma = (power / 10 ** (t["snr_db"] / 10) / 2) ** 0.5
    g = torch.Generator(device=device)
    g.manual_seed(traffic.sub_seed(seed, "noise"))
    clean = clean.to(torch.complex64)
    out = []
    for _ in range(t["noise_draws"]):
        noise = torch.randn((clean.shape[0], 2), generator=g,
                            dtype=torch.float32, device=device) * sigma
        out.append((clean + torch.view_as_complex(noise)).cpu().numpy())
    return ts.cpu().numpy(), out


def run(ctx) -> window.Outcome:
    std, dev, t = ctx.std, ctx.device, ctx.workload["traffic"]
    chk = ctx.workload["check"]
    sent, caps = captures(std, t, ctx.seed, dev)
    ctx.mark("captures")
    fn = _planted(ctx, std.demodulator(ctx.cfg, dev))
    draws = len(caps)
    tap = compare.Tap()
    with _control(ctx), std.demap_tap(tap):
        for i in range(t["warmup_calls"]):
            fn(caps[i % draws])
            ctx.mark(f"warm-up call {i}")
        samples = [traffic.Sample(chk["calls_per_draw"], ctx.seed,
                                  f"check{d}") for d in range(draws)]
        results, kept = [], {}

        def call(i):
            d = i % draws
            slot = samples[d].offer()
            tap.on = slot is not None
            res = fn(caps[d])
            if slot is not None:
                kept[d, slot] = (res.ts, tap.take())
            tap.on = False
            results.append(res)
            res.ts = len(res.ts)
            return caps[d].shape[0]

        rec = window.measure(ctx.seconds, call, dev, **ctx.trace_args)
    peak = ctx.memory_peak()
    ctx.release_program()
    want = chk["min_packets"] * 188
    bad_bytes = [int(np.count_nonzero(got != sent[:len(got)]))
                 + max(want - len(got), 0) + max(len(got) - len(sent), 0)
                 for got, _ in kept.values()]
    lim = chk["limits"]
    name = std.DEMAP_CHECK
    demap = []
    for d in sorted({d for d, _ in kept}):
        ref = std.demap_reference(torch.from_numpy(caps[d]).to(dev))
        demap += [std.demap_err(got, ref, chk)
                  for (dd, _), (_, got) in sorted(kept.items()) if dd == d]
        del ref
    short = sum(n < want for n in (r.ts for r in results))
    flags = [std.bad_flags(r) for r in results]
    return window.Outcome(
        record=rec,
        checks={"ts_bad_bytes": (sum(bad_bytes), lim["ts_bad_bytes"]),
                "bad_flags": (sum(flags), lim["bad_flags"]),
                name: (max(demap), lim[name])},
        attempted=rec.calls,
        failed=sum(f > 0 for f in flags) + sum(b > 0 for b in bad_bytes)
        + sum(e > lim[name] for e in demap) + short,
        memory_peak_bytes=peak,
        info={"rs_corrected_per_call":
              sum(int(r.rs_errors.sum()) for r in results) / len(results)},
        work={"blocks_per_call": t["blocks_per_call"],
              "viterbi": std.viterbi_work(t["blocks_per_call"])})


def _control(ctx):
    """The program's receiver at a lower precision, for a control run
    ("control-<precision>"), never for the benchmark's."""
    if ctx.plant and ctx.plant.startswith("control-"):
        return ctx.std.lower_precision_rx(ctx.plant.split("-", 1)[1])
    return contextlib.nullcontext()


def _planted(ctx, fn):
    """The program's receiver, or (for fault runs, never the benchmark's)
    one that drops half of what it decoded, or alters one byte."""
    if ctx.plant is None or ctx.plant.startswith("control-"):
        return fn
    if ctx.plant == "half":
        def half(iq):
            res = fn(iq)
            res.ts = res.ts[:len(res.ts) // 2]
            return res
        return half
    if ctx.plant == "altered":
        def altered(iq):
            res = fn(iq)
            res.ts = res.ts.copy()
            res.ts[1000] ^= 1
            return res
        return altered
    raise ValueError(f"no plant {ctx.plant!r} for stream_rx")
