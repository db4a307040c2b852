"""Named spans on the served path, on the profiler's clock.

``span(name)`` marks a stretch of host work, as a ``with`` block or as a
function's decorator.  With no ``torch.profiler`` session active it costs
one check (``torch.autograd._profiler_enabled()``)
and records nothing; while a session is active it is
``torch.profiler.record_function(name)``, so the span lands in the same
Kineto trace as the kernels and copies it launches, on the same clock, and
a span's parent is the span that encloses it on the same thread.  There is
no switch of its own: tracing is on exactly while a profiler session is.

To get the spans, run the calls under a session and export its trace::

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        rx.dvbt.demodulate_stream(cfg, iq, device="cuda")
    prof.export_chrome_trace("rx.json")     # chrome://tracing, Perfetto

Each served call has one top span, which every other span of the call
nests inside:

``dtv.rx.dvbt``, ``dtv.rx.j83b``
    ``rx/dvbt.demodulate_stream``, ``rx/j83b.demodulate_stream``.
``dtv.tx.stream``
    ``modulate_stream`` of ``tx/dvbt.py``, ``tx/j83b.py`` and
    ``tx/dvbt2.py``.

Inside them:

``dtv.stream.copy_in``
    host → card copies of a call's input (``core/cplx.iq_to_device``;
    each TS block of a ``modulate_stream`` loop).
``dtv.stream.fill``
    one chunk of host IQ copied into a pinned slot
    (``utils/staging.py``), on a thread of the staging pool, so never
    inside another span of the call's thread.  ``span`` records only on
    a thread where the profiler is enabled, and a ``torch.profiler``
    session enables the thread that starts it, so a session over the
    served calls holds none of these.
``dtv.sizing``
    ``utils/device.working_bytes``, the query that sizes a stage's passes.
``dtv.rx.front_end``
    ``rx/dvbt._front_end`` (each group of superframes), ``rx/j83b.front``.
``dtv.rx.viterbi``
    the receivers' Viterbi decode; the ranges ``viterbi_acs`` and
    ``viterbi_traceback`` of ``ops/viterbi.py`` nest inside it.
``dtv.rx.rs_decode``
    ``rx/dvbt.decode_outer``; J.83B's RS decode and extension check.
``dtv.rx.deframe``
    DVB-T's energy de-dispersal; J.83B's FSYNC check, derandomizer,
    de-interleaver and transport checksum.
``dtv.stream.wait``
    the wait for the card's queue right before a call first reads a result
    on the host, where the host blocks anyway; it keeps the copy spans free
    of waiting for the card.
``dtv.stream.copy_out``
    card → host copies of the results.
``dtv.stream.host``
    host-only work after the results arrive (DVB-T's TPS fields and pilot
    phase check, ``np.concatenate`` of a ``modulate_stream``'s blocks).
``dtv.graph.call``
    ``utils/graph.StaticCall.__call__``, with its steps
    ``dtv.graph.copy_in``, ``dtv.graph.replay`` (on the CPU, the eager run
    on the static buffers) and ``dtv.graph.copy_out``;
    ``dtv.graph.capture`` is a first call's warm-up and capture.

Inside a captured CUDA graph a span is host-only: a replay is one host
launch, and nothing the span marked is replayed.  The ranges
``viterbi_acs``, ``viterbi_traceback`` and ``ldpc_minsum`` of the
decoders, and ``rs_decode_kernel`` around the RS kernel's launch
(``ops/rs_decode.py``, on the card only), go through ``span`` too, under
those names.
"""

from __future__ import annotations

import functools

import torch


class span:
    """``with span(name):`` or ``@span(name)``: ``record_function(name)``
    while a profiler session is active, else one check and nothing
    more."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name, self._range = name, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


def wait(device: torch.device) -> None:
    """Wait, inside a ``dtv.stream.wait`` span, for the work queued on
    ``device``'s current stream (nothing to wait for on the CPU)."""
    with span("dtv.stream.wait"):
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
