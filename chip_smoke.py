#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with an H100 (sm_90a) and the CUDA
toolkit: ``python3 chip_smoke.py``.  It builds the port's CUDA kernel from
``dtv_utils_torch/csrc``, holds it against its plain PyTorch version, drives
the J.83B modulator (``modulate_stream``, then the ``qam-mod`` CLI) on the
card at its full size, checks the output against
``tests/golden/j83b_torch_smoke.json`` (made from the JAX reference by
``tests/test_torch_j83b.py``), and times the serving shape of ``bench.py``.
Every check raises on failure, so the exit code is non-zero if any phase
fails.  The last two lines of stdout are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  It never imports JAX.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "j83b_torch_smoke.json"

FIR_TOL = dict(atol=1e-6, rtol=1e-6)   # kernel vs plain: fp32 sums in two orders
IQ_ATOL = 2e-6                          # card IQ vs the JAX reference's on a CPU
FIR_SIZES = (1_806_210, 40_000, 1)      # main-path n, a ragged tile, one cell
N_STREAMS = 4                           # bench.py's J.83B serving shape
TIMED_ROUNDS = 25                       # per repeat; 3 repeats show the spread


def seeded_ts(seed: int, n_bytes: int) -> np.ndarray:
    """Pseudo-random TS bytes with a 0x47 sync byte every 188, from a
    splitmix64 hash of the byte index: the same bytes on any NumPy version
    (a Generator's stream may change between releases)."""
    x = np.arange(n_bytes, dtype=np.uint64) + np.uint64(
        seed * 0x9E3779B97F4A7C15 % 2**64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    ts = (x >> np.uint64(56)).astype(np.uint8)
    ts[::188] = 0x47
    return ts


def sha256(*arrays: np.ndarray) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def state_digest(d: dict) -> str:
    """sha256 of a J.83B state's integer fields, from host arrays."""
    return sha256(*(np.asarray(d[k]) for k in
                    ("ilv_carry", "conv_a", "conv_b", "diff_state")))


def check_fir(dev, taps) -> float:
    """Kernel against the plain version on the card; returns max |Δ|."""
    from dtv_utils_torch.ops import fir

    g = torch.Generator(device=dev).manual_seed(83)
    worst = 0.0
    for n in FIR_SIZES:
        x = torch.randn(2, fir.HIST + n, generator=g, device=dev)
        got = fir.polyphase_interp2(x, taps, n)
        want = fir.interp2_reference(x, taps, n)
        torch.testing.assert_close(got, want, **FIR_TOL)
        err = (got - want).abs().max().item()
        print(f"fir n={n}: max|d|={err:.3e}")
        worst = max(worst, err)
    # two chained calls carrying the 49-sample tail == one call on the whole
    n1, n2 = 40_000, 33_333
    cells = torch.randn(2, n1 + n2, generator=g, device=dev)
    tail = torch.zeros(2, fir.HIST, device=dev)
    ext1 = torch.cat([tail, cells[:, :n1]], dim=1)
    out1 = fir.polyphase_interp2(ext1, taps, n1)
    ext2 = torch.cat([ext1[:, -fir.HIST:], cells[:, n1:]], dim=1)
    out2 = fir.polyphase_interp2(ext2, taps, n2)
    want = fir.interp2_reference(torch.cat([tail, cells], dim=1), taps,
                                 n1 + n2)
    got = torch.cat([out1, out2], dim=1)
    torch.testing.assert_close(got, want, **FIR_TOL)
    err = (got - want).abs().max().item()
    print(f"fir chained {n1}+{n2}: max|d|={err:.3e}")
    return max(worst, err)


def time_fir(dev, taps) -> tuple[float, float]:
    """ms per call at the main-path size: kernel and plain, in turns."""
    from dtv_utils_torch.ops import fir
    from dtv_utils_torch.utils.timing import time_cuda

    n = FIR_SIZES[0]
    x = torch.randn(2, fir.HIST + n, device=dev)
    runs = {"kernel": [], "plain": []}
    fns = {"kernel": lambda: fir.polyphase_interp2(x, taps, n),
           "plain": lambda: fir.interp2_reference(x, taps, n)}
    for side in ("plain", "kernel", "kernel", "plain"):
        runs[side].append(time_cuda(fns[side], iters=20))
    print(f"fir timings (ms): {runs}")
    return (sum(runs["kernel"]) / 2, sum(runs["plain"]) / 2)


def check_slice(dev, golden: dict) -> tuple[int, np.ndarray]:
    """modulate_stream over the golden's superblocks, checked against the
    golden; returns the FIR kernel launches it made and its IQ."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.ops import fir
    from dtv_utils_torch.tx import j83b as txq

    cfg = J83bConfig()
    n_sb = golden["superblocks"]
    ts = seeded_ts(golden["seed"], n_sb * txq.SUPERBLOCK_BYTES)
    if sha256(ts) != golden["ts_sha256"]:
        raise AssertionError("seeded_ts no longer makes the golden's input")

    fir.LAUNCHES = 0
    iq, state = txq.modulate_stream(cfg, ts, device=dev)
    launches = fir.LAUNCHES
    print(f"modulate_stream: {n_sb} superblocks, {launches} FIR launches")

    want_len = n_sb * 2 * txq.SUPERBLOCK_SYMBOLS
    if iq.shape != (want_len,) or iq.dtype != np.complex64:
        raise AssertionError(f"IQ {iq.dtype} {iq.shape}, want complex64 "
                             f"({want_len},)")
    if not np.isfinite(iq.view(np.float32)).all():
        raise AssertionError("non-finite IQ")
    idx = np.asarray(golden["iq_index"])
    want = (np.asarray(golden["iq_re"], np.float32)
            + 1j * np.asarray(golden["iq_im"], np.float32))
    err = np.abs(iq[idx] - want).max()
    print(f"IQ at {idx.size} golden indices: max|d|={err:.3e}")
    np.testing.assert_allclose(iq[idx], want, rtol=0, atol=IQ_ATOL)
    if state_digest(txq.state_to_numpy(state)) != golden["state_sha256"]:
        raise AssertionError("final state differs from the golden")

    st = txq.init_state(cfg, device=dev)
    blk = txq.SUPERBLOCK_BYTES
    for i in range(n_sb):
        block = torch.from_numpy(ts[i * blk:(i + 1) * blk]).to(dev)
        cells, st = txq.encode_to_cells(cfg, block, st)
        if sha256(cells.cpu().numpy()) != golden["cells_sha256"][i]:
            raise AssertionError(f"superblock {i}: cells differ from golden")
    print("cells sha256 and state digest match the golden")
    return launches, iq


def check_cli(golden: dict, iq: np.ndarray, device: str) -> None:
    """``python -m dtv_utils_torch.cli qam-mod`` writes the same IQ."""
    from dtv_utils_torch.tx import j83b as txq

    ts = seeded_ts(golden["seed"],
                   golden["superblocks"] * txq.SUPERBLOCK_BYTES)
    with tempfile.TemporaryDirectory() as d:
        src, dst = Path(d, "in.ts"), Path(d, "out.cfile")
        ts.tofile(src)
        subprocess.run([sys.executable, "-m", "dtv_utils_torch.cli",
                        "qam-mod", str(src), str(dst), "--device", device],
                       cwd=ROOT, check=True, timeout=300)
        got = np.fromfile(dst, dtype=np.complex64)
    if not np.array_equal(got, iq):
        raise AssertionError("qam-mod CLI output differs from modulate_stream")
    print("qam-mod CLI output equals modulate_stream's")


def serve(dev) -> tuple[list[float], list[float]]:
    """bench.py's serving shape: 4 streams round-robin, one superblock per
    launch, a distinct device-resident input per launch, warm-up excluded.
    Returns three repeats each of Msamples/s (4 streams) and of ms per
    superblock on one stream."""
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.tx import j83b as txq
    from dtv_utils_torch.utils.timing import timed_stream

    cfg = J83bConfig()
    blk = txq.SUPERBLOCK_BYTES
    g = torch.Generator(device=dev).manual_seed(2)

    def inputs(count):
        ts = torch.randint(0, 256, (count, blk), generator=g, device=dev,
                           dtype=torch.uint8)
        ts[:, ::188] = 0x47
        return list(ts)

    def fn(x, st):
        return txq.modulate_superblock(cfg, x, st)

    msps, ms = [], []
    for _ in range(3):
        states = [txq.init_state(cfg, device=dev) for _ in range(N_STREAMS)]
        sec = timed_stream(fn, inputs(N_STREAMS * (1 + TIMED_ROUNDS)), states)
        msps.append(TIMED_ROUNDS * N_STREAMS * 2 * txq.SUPERBLOCK_SYMBOLS
                    / sec / 1e6)
        one = [txq.init_state(cfg, device=dev)]
        sec = timed_stream(fn, inputs(1 + TIMED_ROUNDS), one)
        ms.append(sec / TIMED_ROUNDS * 1e3)
    return msps, ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from dtv_utils_torch import resolve_device
    from dtv_utils_torch.core.config import J83bConfig
    from dtv_utils_torch.ops import _build, fir
    from dtv_utils_torch.tx import j83b as txq

    golden = json.loads(GOLDEN.read_text())
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(dev)

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[dev.index]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"built {Path(lib._name).name} in {time.perf_counter() - t0:.1f} s")

    # 3. FIR kernel against its plain version, without TF32 in the plain one
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    taps = txq.rrc_taps(J83bConfig())
    max_err = check_fir(dev, taps)
    fir_ms, plain_ms = time_fir(dev, taps)
    print(f"fir n={FIR_SIZES[0]}: kernel {fir_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms ({card})")

    # 4. the slice, then the same input through the CLI
    launches, iq = check_slice(dev, golden)
    if launches != golden["superblocks"]:
        raise AssertionError(f"the FIR kernel ran {launches} times for "
                             f"{golden['superblocks']} superblocks")
    check_cli(golden, iq, "cuda")

    # 5. serving throughput
    msps, sb_ms = serve(dev)
    print(f"j83b serving: median {sorted(msps)[1]:.3f} Msamples/s "
          f"(repeats {', '.join(f'{v:.3f}' for v in msps)}; {N_STREAMS} "
          f"streams, {TIMED_ROUNDS} timed rounds each) on {card}")
    print(f"j83b one stream: median {sorted(sb_ms)[1]:.3f} ms/superblock "
          f"(repeats {', '.join(f'{v:.3f}' for v in sb_ms)}) on {card}")

    print(json.dumps({"kernels": [{
        "name": "fir_interp2", "route": "cuda",
        "source": "dtv_utils_torch/csrc/fir_interp2.cu",
        "replaces": "dtv_utils_tpu/ops/fir.py:66",
        "launches": launches, "max_abs_err": max_err,
        "ms": fir_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
