"""Staging host IQ for the card (``dtv_utils_torch/utils/staging.py``) on
the CPU: the chunk plan, and the ring's fill-and-issue loop driven by a
host stand-in for the copy to the card, which copies a slot only when the
ring waits on it, as a copy stream would have by then.  A ring that
refilled a slot before its copy had run would hand on the wrong bytes.
The CUDA path itself is held to ``torch.from_numpy(x).cuda()`` in
``tests/test_torch_rx_gpu.py``.  Also ``core/cplx.iq_to_device``'s
choice of path and its refusals.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from dtv_utils_torch.core import cplx
from dtv_utils_torch.utils import staging

CHUNK = 5


def _iq(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(2 * n, dtype=np.float32).view(np.complex64)


@pytest.mark.parametrize("n", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1,
                               3 * CHUNK + 7])
def test_chunk_plan_covers_each_index_once_in_order(n):
    plan = staging.chunk_plan(n, CHUNK)
    assert [i for a, b in plan for i in range(a, b)] == list(range(n))
    assert all(0 < b - a <= CHUNK for a, b in plan)
    assert all(b - a == CHUNK for a, b in plan[:-1])
    assert len(plan) == -(-n // CHUNK)


class _LateCopy:
    """The stand-in for a copy issued on a stream: it copies the slot into
    ``out`` only when waited on, once."""

    def __init__(self, out, a, b, slot):
        self.args, self.done = (out, a, b, slot), False
        self.lock = threading.Lock()

    def query(self):
        return self.done

    def synchronize(self):
        with self.lock:
            if not self.done:
                out, a, b, slot = self.args
                out[a:b] = slot[:b - a]
                self.done = True


def _stage(ring: staging.Ring, src: np.ndarray) -> tuple[np.ndarray, list]:
    """``src`` through ``ring`` with late copies: (what landed, slots sent)."""
    out = np.full(src.shape[0], np.nan, dtype=np.complex64)
    copies, sent = [], []

    def send(s, a, b):
        sent.append(s)
        copies.append(_LateCopy(out, a, b, ring.slots[s]))
        return copies[-1]

    ring.run(src, send)
    for c in copies:                  # the call's end waits for every copy
        c.synchronize()
    return out, sent


@pytest.fixture
def ring():
    r = staging.Ring([np.empty(CHUNK, np.complex64) for _ in range(3)],
                     threads=2)
    yield r
    r.close()


@pytest.mark.parametrize("view", ["whole", "strided", "reversed", "offset"])
@pytest.mark.parametrize("n", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1,
                               3 * CHUNK + 7])
def test_ring_hands_on_the_exact_bytes(ring, view, n):
    base = _iq(3 * n + 1, seed=n)
    src = {"whole": base[:n], "strided": base[::3][:n],
           "reversed": base[::-1][:n], "offset": base[1:n + 1]}[view]
    out, sent = _stage(ring, src)
    assert out.tobytes() == np.ascontiguousarray(src).tobytes()
    assert sent == [k % 3 for k in range(len(staging.chunk_plan(n, CHUNK)))]


def test_ring_reuses_its_slots_across_calls(ring):
    # 23 chunks through 3 slots, then a second source at once: each slot
    # is filled again only after the copy that read it
    srcs = [_iq(23 * CHUNK - 2, seed=1), _iq(4 * CHUNK, seed=2)]
    outs, late = [], []
    for src in srcs:
        out = np.zeros(src.shape[0], np.complex64)

        def send(s, a, b, out=out):
            late.append(_LateCopy(out, a, b, ring.slots[s]))
            return late[-1]

        ring.run(src, send)
        outs.append(out)
    for c in late:
        c.synchronize()
    for src, out in zip(srcs, outs):
        np.testing.assert_array_equal(out, src)


def test_ring_fails_cleanly_and_runs_again(ring):
    src = _iq(9 * CHUNK, seed=3)

    def send(s, a, b):
        if a >= 4 * CHUNK:
            raise RuntimeError("copy refused")

    with pytest.raises(RuntimeError, match="copy refused"):
        ring.run(src, send)
    out, _ = _stage(ring, src)
    np.testing.assert_array_equal(out, src)


def test_ring_reports_a_failed_wait(ring):
    class Broken:
        def query(self):
            return False

        def synchronize(self):
            raise RuntimeError("wait failed")

    with pytest.raises(RuntimeError, match="wait failed"):
        ring.run(_iq(9 * CHUNK, seed=4), lambda s, a, b: Broken())


def test_ring_serves_concurrent_callers():
    r = staging.Ring([np.empty(CHUNK, np.complex64) for _ in range(2)],
                     threads=3)
    srcs = [_iq(7 * CHUNK + i, seed=10 + i) for i in range(6)]
    outs: dict[int, np.ndarray] = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def caller(i):
            for _ in range(5):
                outs[i], _ = _stage(r, srcs[i])

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(len(srcs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        r.close()
    for i, src in enumerate(srcs):
        np.testing.assert_array_equal(outs[i], src)


def test_fill_threads_come_from_the_cpus_allowed(monkeypatch):
    monkeypatch.setattr(staging.os, "sched_getaffinity",
                        lambda pid: set(range(3)))
    assert staging.fill_threads() == 3
    monkeypatch.setattr(staging.os, "sched_getaffinity",
                        lambda pid: set(range(64)))
    assert staging.fill_threads() == staging.MAX_THREADS


def _no_staging(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the staging ring")
    monkeypatch.setattr(staging, "to_device", refuse)


def test_iq_to_cpu_is_a_view_of_the_input(monkeypatch):
    _no_staging(monkeypatch)
    x = _iq(64)
    got = cplx.iq_to_device(x, device="cpu")
    assert got.dtype == torch.complex64 and np.shares_memory(got.numpy(), x)
    t = torch.from_numpy(_iq(8).reshape(2, 4))
    assert cplx.iq_to_device(t, device="cpu").data_ptr() == t.data_ptr()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("iq", [
    np.zeros(4, np.complex128), np.zeros(4, np.float32),
    torch.zeros(4, dtype=torch.complex128), torch.zeros(4)],
    ids=["np-c128", "np-f32", "torch-c128", "torch-f32"])
def test_iq_to_device_refuses_other_dtypes(monkeypatch, device, iq):
    _no_staging(monkeypatch)
    with pytest.raises(TypeError, match="complex64"):
        cplx.iq_to_device(iq, device=device)


@pytest.mark.parametrize("make", [
    lambda x: x, lambda x: x[::2], lambda x: x.reshape(4, -1),
    lambda x: torch.from_numpy(x), lambda x: torch.from_numpy(x)[1::3]],
    ids=["array", "strided", "2-d", "tensor", "strided-tensor"])
def test_host_iq_for_a_card_goes_through_the_ring_in_place(monkeypatch,
                                                           make):
    seen = []
    monkeypatch.setattr(staging, "to_device",
                        lambda src, dev: seen.append((src, dev)) or "staged")
    x = _iq(96)
    iq = make(x)
    assert cplx.iq_to_device(iq, device="cuda:0") == "staged"
    (src, dev), = seen
    assert dev == torch.device("cuda", 0) and src.ndim == 1
    assert np.shares_memory(src, x)           # read in place, no copy
    want = iq.numpy() if isinstance(iq, torch.Tensor) else iq
    np.testing.assert_array_equal(src, want.reshape(-1))
