"""Fixed-shape calls captured as CUDA graphs: the port's counterpart of
``jax.jit``.

The JAX package dispatches every serving call as one compiled program per
argument shape (``tx/dvbt.jit_modulator``, ``ops/ldpc_decode.jit_decode``,
the jitted batched runners of ``parallel/stream.py``).  PyTorch runs
eagerly: a call is some 40 to 120 launches, each issued from Python.  A
:class:`StaticCall` captures a call of fixed shapes once into a
``torch.cuda.CUDAGraph`` and replays it, one graph launch on the host per
call; :class:`Jit` keeps one per argument signature.

Buffer protocol, the same on the card and on the CPU:

* one static buffer per tensor argument (every field of a state dataclass
  included); a call copies its arguments in, each checked for shape, dtype
  and device first;
* the card: the first call runs ``fn`` eagerly on the buffers, on a side
  stream (the warm-up: it fills every first-use upload, builds the kernel
  library and cuFFT's plans; the uploads synchronize, so it runs outside
  ``torch.cuda.set_sync_debug_mode``), and returns that result; then
  ``fn`` is captured on the buffers into a graph, in one memory pool per
  device that every graph shares (capture mode ``thread_local``: a call
  in this thread that a capture forbids raises, while another thread's
  CUDA calls, such as a process group's watchdog, go on).  Each later
  call replays the graph on the current stream.  A failed capture raises;
  nothing falls back to the eager chain;
* the CPU (only when the caller asks for it, as the tests do): each call
  runs ``fn`` eagerly on the buffers;
* every result leaf is copied out.  Results and states handed to the
  caller are the caller's: a later call never changes them, even where a
  result was a view of an input buffer (DVB-T2's ``prev_tail`` is the last
  187 bytes of its input), so the order in which a caller copies the next
  block and the state in does not matter.

Graphs share their pool because a call copies its results out before the
next call on the same stream replays anything: what one graph leaves in
the pool is never read after another graph's replay.  The cache of graphs
is an LRU of ``MAX_GRAPHS`` per device.

A graph reads every tensor it was captured on by address.  The capture
therefore holds a reference to each tensor that an op of the capture read
and that the capture did not make (``_Reads``): the device tables of the
chains, including those of the bounded caches (``tx/dvbt.dispersal_rows``,
``tx/dvbt2._stream_plan``), whose eviction would otherwise free memory a
replay reads.  A kernel launched through ``ctypes`` reads its tables by
pointer, unseen by the capture; those tables live in unbounded caches
(``ops/ldpc_decode._device_graph``), and the FIR's taps are a by-value
kernel parameter, captured with the launch.

Launch counters: ``ops/_build.launch`` adds one to ``_build.LAUNCHES``
for each kernel it launches.  The capture launches nothing on the card, so
the counts it added are taken back and kept; each replay adds them again,
so the counters keep counting launches that ran on the card.

TF32 (``torch.backends.cuda.matmul.allow_tf32``, ``cudnn.allow_tf32``) is
baked into a graph at capture: it is part of :class:`Jit`'s key, and a
:class:`StaticCall` refuses a call under another setting.

Spans (``utils/trace``): a call is ``dtv.graph.call``, and its steps
``dtv.graph.copy_in``, ``dtv.graph.replay`` (on the CPU, the eager run on
the buffers) and ``dtv.graph.copy_out``; a first call on the card runs
``dtv.graph.capture`` (warm-up, capture and the warm-up's copy-out) in
place of the last two.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dtv_utils_torch.ops import _build
from dtv_utils_torch.utils.trace import span

MAX_GRAPHS = 8
"""Captured calls kept per device (least recently used evicted first)."""

_LEAF = "tensor"

_POOLS: dict[torch.device, tuple] = {}
_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
_CACHE: dict[torch.device, collections.OrderedDict] = {}


# ---------------------------------------------------------------------------
# Arguments and results as flat lists of tensors
# ---------------------------------------------------------------------------

def _flatten(x, leaves: list):
    """The structure of ``x`` (tensors inside tuples, lists and
    dataclasses, or None), appending its tensors to ``leaves``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _LEAF
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x), tuple((f.name, _flatten(getattr(x, f.name), leaves))
                               for f in dataclasses.fields(x)))
    raise TypeError(f"a captured call takes and returns tensors, tuples, "
                    f"lists, dataclasses and None, not {type(x).__name__}")


def _unflatten(spec, leaves):
    if spec == _LEAF:
        return next(leaves)
    if spec is None:
        return None
    typ, kids = spec
    if dataclasses.is_dataclass(typ):
        return typ(**{name: _unflatten(k, leaves) for name, k in kids})
    return typ(_unflatten(k, leaves) for k in kids)


def signature(args) -> tuple:
    """The structure of ``args`` with each tensor's shape and dtype: one
    captured call serves exactly the calls of one signature."""
    leaves: list[torch.Tensor] = []
    spec = _flatten(args, leaves)
    return spec, tuple((tuple(t.shape), t.dtype) for t in leaves)


def tf32() -> tuple[bool, bool]:
    """The TF32 switches a capture bakes in."""
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _add_launches(delta: dict[str, int]) -> None:
    for kernel, d in delta.items():
        _build.LAUNCHES[kernel] += d


# ---------------------------------------------------------------------------
# What a capture reads
# ---------------------------------------------------------------------------

class _Reads(TorchDispatchMode):
    """Records every tensor an op reads whose storage no earlier op under
    the mode made: the tensors that were alive before, and that a graph
    captured meanwhile reads by address."""

    def __init__(self):
        super().__init__()
        self.made: set[int] = set()
        self.read: dict[int, torch.Tensor] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensors((args, kwargs)):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in self.made:
                self.read.setdefault(ptr, t)
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self.made.add(t.untyped_storage().data_ptr())
        return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


# ---------------------------------------------------------------------------
# One captured call
# ---------------------------------------------------------------------------

class StaticCall:
    """``fn`` on arguments of one signature (that of ``example_args``, a
    tuple), captured as a CUDA graph on a CUDA ``device`` and run eagerly
    on the CPU, through static buffers (see the module note).

    ``capture_s`` is the warm-up and capture's seconds (0 until the first
    call on the card); ``launches`` the kernel launches of one replay, by
    kernel, those it does not launch left out."""

    def __init__(self, fn: Callable, example_args: tuple, *,
                 device: torch.device):
        self.fn, self.device = fn, torch.device(device)
        leaves: list[torch.Tensor] = []
        self.spec = _flatten(tuple(example_args), leaves)
        self.buffers = [torch.empty_like(t, device=self.device,
                                         memory_format=torch.contiguous_format)
                        for t in leaves]
        self.tf32 = tf32()
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out_spec = None
        self.outputs: list[torch.Tensor] = []
        self.reads: list[torch.Tensor] = []
        self.launches: dict = {}
        self.capture_s = 0.0

    @span("dtv.graph.call")
    def __call__(self, *args):
        with span("dtv.graph.copy_in"):
            self._copy_in(args)
        if self.device.type != "cuda":
            with span("dtv.graph.replay"):
                result = self.fn(*self._args())
        elif self.graph is None:
            return self._warm_up_and_capture()
        else:
            with span("dtv.graph.replay"):
                self.graph.replay()
                _add_launches(self.launches)
            result = _unflatten(self.out_spec, iter(self.outputs))
        with span("dtv.graph.copy_out"):
            return self._copy_out(result)

    def _args(self) -> tuple:
        return _unflatten(self.spec, iter(self.buffers))

    def _copy_in(self, args: tuple) -> None:
        if tf32() != self.tf32:
            raise RuntimeError(f"captured with TF32 {self.tf32} (matmul, "
                               f"cudnn), called with {tf32()}")
        leaves: list[torch.Tensor] = []
        spec = _flatten(tuple(args), leaves)
        if spec != self.spec:
            raise ValueError("the arguments' structure differs from the "
                             "captured call's")
        for i, (t, buf) in enumerate(zip(leaves, self.buffers)):
            if t.shape != buf.shape or t.dtype != buf.dtype:
                raise ValueError(f"argument tensor {i}: {t.dtype} "
                                 f"{tuple(t.shape)}, the captured call takes "
                                 f"{buf.dtype} {tuple(buf.shape)}")
            if t.device != self.device:
                raise ValueError(f"argument tensor {i} on {t.device}, the "
                                 f"captured call on {self.device}")
        for t, buf in zip(leaves, self.buffers):
            buf.copy_(t)

    def _copy_out(self, result):
        leaves: list[torch.Tensor] = []
        spec = _flatten(result, leaves)
        return _unflatten(spec, iter([t.clone() for t in leaves]))

    @span("dtv.graph.capture")
    def _warm_up_and_capture(self):
        t0 = time.perf_counter()
        dev = self.device
        side = _side_stream(dev)
        cur = torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)   # first-use uploads, then the
        try:                                # capture's own device sync
            with torch.cuda.device(dev), torch.cuda.stream(side):
                result = self._copy_out(self.fn(*self._args()))
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        cur.wait_stream(side)
        for t in _flat(result):
            t.record_stream(cur)
        before = dict(_build.LAUNCHES)
        graph, reads = torch.cuda.CUDAGraph(), _Reads()
        torch.cuda.set_sync_debug_mode(0)
        try:
            with torch.cuda.device(dev), torch.cuda.graph(
                    graph, pool=_pool(dev), stream=side,
                    capture_error_mode="thread_local"):
                torch.cuda.set_sync_debug_mode(mode)
                with reads:
                    out = self.fn(*self._args())
                torch.cuda.set_sync_debug_mode(0)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            self.launches = {k: n - before[k]
                             for k, n in _build.LAUNCHES.items()
                             if n != before[k]}
            _add_launches({k: -d for k, d in self.launches.items()})
        self.outputs = []
        self.out_spec = _flatten(out, self.outputs)
        self.reads = list(reads.read.values())
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        return result


def _flat(x) -> list[torch.Tensor]:
    leaves: list[torch.Tensor] = []
    _flatten(x, leaves)
    return leaves


def _pool(dev: torch.device):
    if dev not in _POOLS:
        _POOLS[dev] = torch.cuda.graph_pool_handle()
    return _POOLS[dev]


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream every warm-up and capture on ``dev`` runs on (one per
    device, so captures sharing the pool share the stream)."""
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(dev)
    return _STREAMS[dev]


def pool_bytes(device) -> int:
    """Bytes the graphs' shared pool on a CUDA ``device`` holds: the total
    size of the allocator's segments that belong to it."""
    dev = torch.device(device)
    pool = _POOLS.get(dev)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if pool is not None and seg["device"] == dev.index
               and tuple(seg["segment_pool_id"]) == tuple(pool))


# ---------------------------------------------------------------------------
# jit: one captured call per signature
# ---------------------------------------------------------------------------

class Jit:
    """``fn`` as the reference's ``jax.jit(fn)``: each call goes to the
    :class:`StaticCall` of its arguments' signature and the current TF32
    setting on ``device``, made at the first such call and kept in the
    device's LRU of ``MAX_GRAPHS``."""

    def __init__(self, fn: Callable, *, device: torch.device):
        self.fn, self.device = fn, torch.device(device)

    def static_call(self, *args) -> StaticCall:
        """The captured call that ``self(*args)`` runs (made if missing)."""
        cache = _CACHE.setdefault(self.device, collections.OrderedDict())
        key = (self, signature(args), tf32())
        sc = cache.get(key)
        if sc is None:
            sc = cache[key] = StaticCall(self.fn, args, device=self.device)
            while len(cache) > MAX_GRAPHS:
                cache.popitem(last=False)
        cache.move_to_end(key)
        return sc

    def __call__(self, *args):
        return self.static_call(*args)(*args)


def release(device) -> None:
    """Drop every captured call kept for ``device`` and its pool: once no
    graph holds the pool, ``torch.cuda.empty_cache()`` returns its memory
    to the card, and the next capture starts a new pool."""
    dev = torch.device(device)
    _CACHE.pop(dev, None)
    _POOLS.pop(dev, None)
