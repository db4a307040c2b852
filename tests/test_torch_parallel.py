"""The port's batched and sharded streaming (dtv_utils_torch.parallel,
dtv_utils_torch.entry) on the CPU.

The state derivations equal the JAX reference's field for field; batched
DVB-T stays within max|Δ|/rms < 1e-4 of the reference's
``batched_dvbt_modulator`` (the port's FFT is pocketfft, the reference's a
float32 matmul DFT).  Against the port's own serial chain everything is
bit-exact: batched calls (continuations included), sharded runs in gloo
worker processes (``tests/torch_parallel_worker.py``, which imports no JAX;
each rank reads only its stripe of the input file), and a 2-rank
``dryrun_multichip``.  Inputs are seeded NumPy TS with 0x47 sync bytes.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dtv_utils_tpu.core import config as jconfig
from dtv_utils_tpu.parallel import stream as JS
from dtv_utils_torch.core import cplx
from dtv_utils_torch.core.config import (CodeRate, Constellation, DvbtConfig,
                                         GuardInterval, J83bConfig,
                                         TransmissionMode)
from dtv_utils_torch.entry import dryrun_multichip, entry
from dtv_utils_torch.models.dvbt2 import PROFILES
from dtv_utils_torch.ops import fir
from dtv_utils_torch.parallel import multihost as MH
from dtv_utils_torch.parallel import stream as S
from dtv_utils_torch.rx import dvbt as rxd
from dtv_utils_torch.tx import dvbt as txd
from dtv_utils_torch.tx import dvbt2 as txt2
from dtv_utils_torch.tx import j83b as txq

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
IQ_REL = 1e-4                      # max|Δ|/rms, port vs reference IQ

M, C, R, G = TransmissionMode, Constellation, CodeRate, GuardInterval
CFG = DvbtConfig(mode=M.M2K, bandwidth_mhz=6, constellation=C.QPSK,
                 code_rate=R.R1_2, guard=G.G1_4)     # tests/test_parallel.py
CFG64 = DvbtConfig(mode=M.M2K, bandwidth_mhz=8, constellation=C.QAM64,
                   code_rate=R.R3_4, guard=G.G1_8)   # tests/test_multihost.py
FLAGSHIP = DvbtConfig(mode=M.M8K, bandwidth_mhz=8, constellation=C.QAM64,
                      code_rate=R.R7_8, guard=G.G1_32)
BLADE = PROFILES["blade"]
J83B = J83bConfig()
HALO = S.HALO_PACKETS * 188

# world size and blocks per rank of each sharded case (worker CASES keys)
SHARDED = {"dvbt": (2, 2), "dvbt64": (2, 2), "dvbt2": (2, 2), "j83b": (3, 2)}
BLOCK_BYTES = {"dvbt": CFG.ts_bytes_per_superframe,
               "dvbt64": CFG64.ts_bytes_per_superframe,
               "dvbt2": BLADE.payload_bytes_per_frame,
               "j83b": txq.SUPERBLOCK_BYTES}


def _ts(n_bytes: int, seed: int) -> np.ndarray:
    ts = np.random.default_rng(seed).integers(0, 256, size=n_bytes,
                                              dtype=np.uint8)
    ts[::188] = 0x47
    return ts


def _jcfg(cfg):
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("mode", "constellation", "code_rate", "guard"):
            v = getattr(jconfig, type(v).__name__)[v.name]
        kw[f.name] = v
    return jconfig.DvbtConfig(**kw)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max()
                 / np.sqrt(np.mean(np.abs(want) ** 2)))


def _serial(name: str, ts: np.ndarray) -> np.ndarray:
    """The port's serial chain over ``ts``, one row per block."""
    if name == "j83b":
        iq, _ = txq.modulate_stream(J83B, ts, device="cpu")
        rails = np.stack([iq.real, iq.imag]).astype(np.float32)
        return rails.reshape(2, -1, 2 * txq.SUPERBLOCK_SYMBOLS).transpose(
            1, 0, 2)
    cfg = {"dvbt": CFG, "dvbt64": CFG64}.get(name)
    if cfg is not None:
        iq, _ = txd.modulate_stream(cfg, ts, device="cpu")
        return iq.reshape(-1, cfg.samples_per_superframe)
    iq, _ = txt2.modulate_stream(BLADE, ts, device="cpu")
    return iq.reshape(-1, txt2.samples_per_frame(BLADE))


# ---------------------------------------------------------------------------
# State derivations against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_idx", [1, 2, 7, 8])
@pytest.mark.parametrize("cfg", [CFG, FLAGSHIP], ids=["2k", "flagship"])
def test_derive_state_matches_jax(cfg, block_idx):
    tail = _ts(HALO, 100 + block_idx)
    want = JS.derive_state(_jcfg(cfg), jnp.asarray(tail),
                           jnp.int32(block_idx))
    got = S.derive_state(cfg, torch.from_numpy(tail), block_idx)
    got = txd.state_to_numpy(got)
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        assert got[f.name].dtype == w.dtype, f.name
        np.testing.assert_array_equal(got[f.name], w, err_msg=f.name)


def test_j83b_conv_consts_match_jax():
    for got, want in zip(S._j83b_conv_consts(), JS._j83b_conv_consts()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_derive_j83b_ilv_carry_matches_jax():
    tail = _ts(S.J83B_HALO_PACKETS * 188, 7)
    assert S.J83B_HALO_PACKETS == JS.J83B_HALO_PACKETS
    want = np.asarray(JS.derive_j83b_ilv_carry(jnp.asarray(tail)))
    got = S.derive_j83b_ilv_carry(torch.from_numpy(tail))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", range(4))
def test_rotate_quadrants_is_exact(k):
    """(−j)^k by rail swaps and sign flips equals the complex product on
    64-QAM cells exactly, for a device-side int32 k."""
    rails = torch.from_numpy(txq.CONSTELLATION_64_RAILS)
    want = torch.complex(rails[0], rails[1]) * (-1j) ** k
    got = S._rotate_quadrants(rails, torch.tensor(k, dtype=torch.int32))
    assert torch.equal(torch.complex(got[0], got[1]), want)


@pytest.mark.parametrize("n_before", [1, 3])
def test_derive_state_matches_serial(n_before):
    """The state derived from the raw tail equals the serial chain's state
    after ``n_before`` superframes."""
    blk = CFG.ts_bytes_per_superframe
    ts = _ts(n_before * blk, 30 + n_before)
    _, want = txd.modulate_stream(CFG, ts, device="cpu")
    got = S.derive_state(CFG, torch.from_numpy(ts[-HALO:]), n_before)
    want, got = txd.state_to_numpy(want), txd.state_to_numpy(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError):
        S.derive_state(CFG, torch.from_numpy(ts[-HALO:]), 0)


# ---------------------------------------------------------------------------
# Batched: one pass of each chain over L blocks
# ---------------------------------------------------------------------------

@functools.cache
def _dvbt_batched_case() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """6 superframes of CFG: the serial IQ, the batched 4 + a 2-superframe
    continuation."""
    blk = CFG.ts_bytes_per_superframe
    ts = _ts(6 * blk, 9)
    fn = S.batched_dvbt_modulator(CFG, device="cpu")
    first = fn(torch.from_numpy(ts[:4 * blk].reshape(4, blk)), None, 0)
    rest = fn(torch.from_numpy(ts[4 * blk:].reshape(2, blk)),
              torch.from_numpy(ts[4 * blk - HALO:4 * blk]), 4)
    return ts, _serial("dvbt", ts), torch.cat([first, rest]).numpy()


def test_batched_dvbt_equals_serial():
    _, want, got = _dvbt_batched_case()
    assert got.dtype == np.complex64 and got.shape == want.shape == (
        6, CFG.samples_per_superframe)
    np.testing.assert_array_equal(got, want)


def test_batched_dvbt_close_to_jax():
    ts, _, got = _dvbt_batched_case()
    blk = CFG.ts_bytes_per_superframe
    fn = JS.batched_dvbt_modulator(_jcfg(CFG))
    first = np.asarray(fn(jnp.asarray(ts[:4 * blk].reshape(4, blk)),
                          jnp.zeros(HALO, jnp.uint8), jnp.int32(0)))
    rest = np.asarray(fn(jnp.asarray(ts[4 * blk:].reshape(2, blk)),
                         jnp.asarray(ts[4 * blk - HALO:4 * blk]),
                         jnp.int32(4)))
    rails = np.concatenate([first, rest])                   # [6, 2, n]
    want = (rails[:, 0] + 1j * rails[:, 1]).astype(np.complex64)
    rel = _rel(got, want)
    assert rel < IQ_REL, rel


def test_batched_dvbt_checks_its_input():
    fn = S.batched_dvbt_modulator(CFG, device="cpu")
    blk = CFG.ts_bytes_per_superframe
    with pytest.raises(ValueError):
        fn(torch.zeros((2, blk - 188), dtype=torch.uint8), None, 0)
    with pytest.raises(ValueError):
        fn(torch.zeros((2, blk), dtype=torch.int32), None, 0)


def test_batched_dvbt2_equals_serial():
    blk = BLADE.payload_bytes_per_frame
    ts = _ts(3 * blk, 11)
    got = S._batched_dvbt2_modulator(BLADE, device="cpu")(
        torch.from_numpy(ts.reshape(3, blk)), None, 0)
    np.testing.assert_array_equal(got.numpy(), _serial("dvbt2", ts))


def test_batched_dvbt2_tone_reservation_equals_serial():
    """With tone reservation the peak search and the kernel lookup run per
    symbol over the L frames' symbols in one pass."""
    cfg = dataclasses.replace(BLADE, papr_tr=True)
    blk = cfg.payload_bytes_per_frame
    ts = _ts(2 * blk, 14)
    got = S._batched_dvbt2_modulator(cfg, device="cpu")(
        torch.from_numpy(ts.reshape(2, blk)), None, 0)
    want, _ = txt2.modulate_stream(cfg, ts, device="cpu")
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)


def test_batched_dvbt2_continuation_past_int32_wrap():
    """Frame 20,000 of a blade stream: k·n overflows int32 there (the
    reference's ``global_idx * blk``), so a wrapped product would give
    another packet phase.  The batched call must carry the serial chain's
    phase, stepped frame by frame, and equal the serial chain from it."""
    k, blk = 20_000, BLADE.payload_bytes_per_frame
    phase = 0
    for _ in range(k):
        phase = (phase + blk) % 188
    wrapped = (k * blk + 2**31) % 2**32 - 2**31          # int32 product
    assert k * blk > 2**31 and wrapped % 188 != phase
    tail = _ts(187, 12)
    ts = _ts(2 * blk, 13)
    state = S._dvbt2_state(BLADE, torch.from_numpy(tail), k,
                           torch.device("cpu"))
    assert int(state.packet_phase) == phase
    got = S._batched_dvbt2_modulator(BLADE, device="cpu")(
        torch.from_numpy(ts.reshape(2, blk)), torch.from_numpy(tail), k)
    serial = txt2.state_from_numpy(
        {"packet_phase": np.int32(phase), "prev_tail": tail}, device="cpu")
    want, _ = txt2.modulate_stream(BLADE, ts, serial, device="cpu")
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)


def test_batched_j83b_equals_serial():
    """Three superblocks in one call of the chain, one FIR call, against
    the serial stream superblock by superblock."""
    ts = _ts(3 * txq.SUPERBLOCK_BYTES, 13)
    iq, state = txq.modulate_superblock(J83B, torch.from_numpy(ts),
                                        txq.init_state(J83B, device="cpu"))
    want, want_state = txq.modulate_stream(J83B, ts, device="cpu")
    np.testing.assert_array_equal(cplx.rails_to_np(iq), want)
    for k, v in txq.state_to_numpy(want_state).items():
        np.testing.assert_array_equal(txq.state_to_numpy(state)[k], v,
                                      err_msg=k)


def test_ifft_in_calls(monkeypatch):
    """The card's cut of a long 32K batch (cuFFT's plan changes at 128
    rows): calls of at most IFFT_MAX_ROWS rows into one output, each equal
    to its own call; a CPU batch stays one call."""
    from dtv_utils_torch.ops import cfft

    rows = cfft.IFFT_MAX_ROWS[32768]
    g = torch.Generator().manual_seed(6)
    x = torch.complex(torch.randn(rows + 3, 32768, generator=g),
                      torch.randn(rows + 3, 32768, generator=g))
    want = torch.cat([torch.fft.ifft(c, norm="forward")
                      for c in x.split(rows)])
    calls = []
    real_ifft = torch.fft.ifft
    monkeypatch.setattr(torch.fft, "ifft", lambda a, *k, **kw: (
        calls.append(a.shape[0]), real_ifft(a, *k, **kw))[1])
    assert torch.equal(cfft._ifft_in_calls(x, rows), want)
    assert calls == [rows, 3]
    calls.clear()
    cfft.ifft_unnormalized(x)
    assert calls == [rows + 3]


def test_fir_plain_version_is_batch_invariant():
    """The CPU's FIR over 3 superblocks of cells equals 3 chained calls with
    the 49-cell history carried, and a 1,000-cell call equals the long
    call's prefix: each output is a sum in a fixed order."""
    n = txq.SUPERBLOCK_SYMBOLS
    g = torch.Generator().manual_seed(5)
    cells = torch.randn(2, 3 * n, generator=g)
    tail = torch.randn(2, fir.HIST, generator=g)
    taps = txq.rrc_taps(J83B)
    whole, _ = txq.rrc_interpolate(cells, tail, taps)
    outs, t = [], tail
    for i in range(3):
        out, t = txq.rrc_interpolate(cells[:, i * n:(i + 1) * n], t, taps)
        outs.append(out)
    assert torch.equal(whole, torch.cat(outs, 1))
    prefix, _ = txq.rrc_interpolate(cells[:, :1000], tail, taps)
    assert torch.equal(prefix, whole[:, :2000])


# ---------------------------------------------------------------------------
# Sharded: gloo worker processes, each reading only its stripe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Runs every case of SHARDED in worker processes (the world-2 cases
    in one group, J.83B in a world-3 group, both at once); returns
    {case: (input TS, [per-rank npz])}."""
    d = tmp_path_factory.mktemp("sharded")
    inputs = {}
    for seed, (name, (world, per)) in enumerate(SHARDED.items(), 40):
        inputs[name] = _ts(world * per * BLOCK_BYTES[name], seed)
        inputs[name].tofile(d / f"{name}.ts")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    groups = {}
    for name, (world, _) in SHARDED.items():
        groups.setdefault(world, []).append(name)
    procs = []
    for world, names in groups.items():
        init = (d / f"rendezvous{world}").as_uri()
        procs += [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), init, str(d),
             *names], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env) for r in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "TORCH_PARALLEL_OK" in out, err[-3000:]
    return {name: (inputs[name],
                   [np.load(d / f"{name}.{r}.npz") for r in range(world)])
            for name, (world, _) in SHARDED.items()}


@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_equals_serial(sharded, name):
    """Every rank's output equals its slice of the serial chain, bit for
    bit (DVB-T 2K and 64-QAM, DVB-T2 blade at world 2; J.83B at world 3,
    where the quadrant prefix spans two earlier ranks)."""
    ts, ranks = sharded[name]
    want = _serial(name, ts)
    per = SHARDED[name][1]
    for r, res in enumerate(ranks):
        assert int(res["first"]) == r * per
        got = res["iq"]
        assert got.dtype == want.dtype and got.shape == (per,) + want.shape[1:]
        np.testing.assert_array_equal(got, want[r * per:(r + 1) * per],
                                      err_msg=f"{name} rank {r}")


def test_multihost_reads_only_its_stripe(sharded):
    """Host-striped ingest: rank r read exactly the bytes of its blocks."""
    for name, (world, per) in SHARDED.items():
        blk = BLOCK_BYTES[name]
        for r, res in enumerate(sharded[name][1]):
            assert res["read"].tolist() == [r * per * blk,
                                            (r + 1) * per * blk], name


def test_sharded_dvbt_output_decodes(sharded):
    """The sharded DVB-T output decodes with the port's receiver back to
    the exact TS (all but the interleaver's tail in flight)."""
    ts, ranks = sharded["dvbt"]
    iq = np.concatenate([res["iq"].reshape(-1) for res in ranks])
    res = rxd.demodulate_stream(CFG, iq, device="cpu")
    n = len(res.ts)
    assert n >= (len(ts) // CFG.ts_bytes_per_superframe - 1) \
        * CFG.ts_bytes_per_superframe
    np.testing.assert_array_equal(res.ts, ts[:n])
    assert res.rs_ok.all() and res.tps["all_bch_ok"]


def test_sharded_world1_in_process_equals_batched(tmp_path):
    """World size 1 in this process (gloo): each sharded modulator equals
    the one-device path, and a group of the wrong backend is refused."""
    blk = CFG.ts_bytes_per_superframe
    ts = torch.from_numpy(_ts(2 * blk, 50).reshape(2, blk))
    tsq = torch.from_numpy(_ts(txq.SUPERBLOCK_BYTES, 51).reshape(1, -1))
    MH.initialize((tmp_path / "rdv").as_uri(), 1, 0, device="cpu")
    try:
        assert S.make_mesh() is dist.group.WORLD
        assert MH.host_block_range(4) == (0, 4)
        got = S.sharded_dvbt_modulator(CFG)(ts)
        want = S.batched_dvbt_modulator(CFG, device="cpu")(ts, None, 0)
        assert torch.equal(got, want)
        got = S.sharded_j83b_modulator(J83B)(tsq)
        want, _ = txq.modulate_superblock(J83B, tsq.reshape(-1),
                                          txq.init_state(J83B, device="cpu"))
        assert torch.equal(got[0], want)
        with pytest.raises(RuntimeError, match="nccl"):
            S._check_backend(None, torch.device("cuda"))
        with pytest.raises(ValueError):
            MH.make_local_blocks(np.zeros((3, blk), np.uint8), 4,
                                 device="cpu")
    finally:
        dist.destroy_process_group()


def test_sharded_without_group_raises():
    assert not dist.is_initialized()
    for make, cfg in ((S.sharded_dvbt_modulator, CFG),
                      (S.sharded_dvbt2_modulator, BLADE),
                      (S.sharded_j83b_modulator, J83B)):
        with pytest.raises(RuntimeError, match="process group"):
            make(cfg)
    with pytest.raises(RuntimeError, match="process group"):
        MH.host_block_range(4)


def test_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="is_available"):
        S.batched_dvbt_modulator(CFG)
    with pytest.raises(RuntimeError, match="is_available"):
        S._batched_dvbt2_modulator(BLADE)
    with pytest.raises(RuntimeError, match="is_available"):
        entry()
    with pytest.raises(RuntimeError, match="is_available"):
        MH.initialize((tmp_path / "rdv").as_uri(), 1, 0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="is_available"):
        dryrun_multichip(1)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_entry_equals_modulate_superframe():
    fn, (ts, state) = entry(device="cpu")
    iq, _ = fn(ts, state)
    want, _ = txd.modulate_stream(FLAGSHIP, ts.numpy(), device="cpu")
    assert ts.shape == (FLAGSHIP.ts_bytes_per_superframe,)
    np.testing.assert_array_equal(iq.numpy(), want)


def test_dryrun_multichip_cpu():
    dryrun_multichip(2, device="cpu")
    with pytest.raises(ValueError):
        dryrun_multichip(0, device="cpu")
