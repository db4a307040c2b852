"""The benchmark's plain reference modulators against the repository's
golden data (``tests/golden/*_torch_smoke.json``, made from the JAX
package on the CPU): the carrier grid and cells bit for bit by their
sha256, the IQ at the golden's sampled indices, and the DVB-T stream
state that the reference derives at a superframe boundary.

    python -m pytest dtvbench/tests -q
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dtvbench.reference import dvbt, j83b
from dtvbench.drivers import stream_rx
from dtvbench.standards import dvbt as std_dvbt

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "golden"


def seeded_ts(seed: int, n_bytes: int) -> np.ndarray:
    """The golden files' TS: a splitmix64 hash of the byte index, 0x47
    every 188 bytes (``chip_smoke.seeded_ts``)."""
    x = np.arange(n_bytes, dtype=np.uint64) + np.uint64(
        seed * 0x9E3779B97F4A7C15 % 2**64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    ts = (x >> np.uint64(56)).astype(np.uint8)
    ts[::188] = 0x47
    return ts


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def golden(name: str) -> dict:
    return json.loads((GOLDEN / name).read_text())


def sampled_err(iq: np.ndarray, g: dict) -> float:
    want = np.asarray(g["iq_re"]) + 1j * np.asarray(g["iq_im"])
    rms = np.sqrt(np.mean(np.abs(iq) ** 2))
    return float(np.abs(iq[np.asarray(g["iq_index"])] - want).max() / rms)


@pytest.fixture(scope="module")
def dvbt_golden():
    g = golden("dvbt_torch_smoke.json")
    ts = seeded_ts(g["seed"], g["superframes"] * dvbt.BLOCK_BYTES)
    assert sha(ts) == g["ts_sha256"]
    state, grids = dvbt.init_state("cpu"), []
    for i in range(g["superframes"]):
        blk = torch.from_numpy(ts[i * dvbt.BLOCK_BYTES:
                                  (i + 1) * dvbt.BLOCK_BYTES])
        grid, state = dvbt.encode_to_carriers(blk, state)
        grids.append(grid)
    return g, ts, grids


@pytest.mark.parametrize("sf", [0, 1])
def test_dvbt_carriers_equal_golden(dvbt_golden, sf):
    g, _, grids = dvbt_golden
    rails = torch.view_as_real(grids[sf].to(torch.complex64)).numpy()
    assert sha(rails) == g["carriers_sha256"][sf]


def test_dvbt_iq_matches_golden(dvbt_golden):
    g, _, grids = dvbt_golden
    iq = torch.cat([dvbt.carriers_to_iq(x) for x in grids]).numpy()
    assert iq.shape == (g["superframes"] * dvbt.BLOCK_SAMPLES,)
    # float64 against the golden's float32 FFT
    assert sampled_err(iq, g) < 1e-5
    assert abs(np.sqrt(np.mean(np.abs(iq) ** 2)) / g["iq_rms"] - 1) < 1e-6


def test_dvbt_state_at_boundary_equals_stream(dvbt_golden):
    _, ts, _ = dvbt_golden
    first = torch.from_numpy(ts[:dvbt.BLOCK_BYTES])
    _, after = dvbt.encode_to_carriers(first, dvbt.init_state("cpu"))
    got = dvbt.state_at(first[-dvbt.HALO_PACKETS * 188:], 1)
    assert got.phase == after.phase
    assert torch.equal(got.carry, after.carry)
    assert torch.equal(got.conv, after.conv)


def test_dvbt_reference_continues_a_stream(dvbt_golden):
    """Superframe 1 from the state derived at its start equals the
    second superframe of one call over both."""
    _, ts, grids = dvbt_golden
    t = torch.from_numpy(ts)
    one = std_dvbt.reference(t[dvbt.BLOCK_BYTES:],
                             t[dvbt.BLOCK_BYTES - std_dvbt.HALO_BYTES:
                               dvbt.BLOCK_BYTES], 1)
    assert torch.equal(one, dvbt.carriers_to_iq(grids[1]))


def test_dvbt_bfloat16_is_one_precision_lower(dvbt_golden):
    _, _, grids = dvbt_golden
    full = dvbt.carriers_to_iq(grids[0])
    low = dvbt.carriers_to_iq(grids[0], "bfloat16")
    rel = float((full - low).abs().max() / full.abs().square().mean().sqrt())
    assert 2 ** -12 < rel < 2 ** -4


@pytest.fixture(scope="module")
def j83b_golden():
    g = golden("j83b_torch_smoke.json")
    ts = seeded_ts(g["seed"], g["superblocks"] * j83b.BLOCK_BYTES)
    assert sha(ts) == g["ts_sha256"]
    return g, j83b.encode_to_cells(torch.from_numpy(ts))


@pytest.mark.parametrize("sb", [0, 1])
def test_j83b_cells_equal_golden(j83b_golden, sb):
    g, cells = j83b_golden
    n = cells.shape[0] // g["superblocks"]
    c = cells[sb * n:(sb + 1) * n]
    rails = np.stack([c.real.numpy(), c.imag.numpy()]).astype(np.float32)
    assert sha(rails) == g["cells_sha256"][sb]


def test_j83b_iq_matches_golden(j83b_golden):
    g, cells = j83b_golden
    iq = j83b.interpolate(cells).numpy()
    assert iq.shape == (g["superblocks"] * j83b.BLOCK_SAMPLES,)
    assert sampled_err(iq, g) < 1e-5


def test_capture_noise_is_seeded_at_its_snr():
    """The receive cells' captures: the same seed gives the same bytes,
    and the noise sits at snr_db below the signal's mean power."""
    t = {"blocks_per_call": 1, "snr_db": 20.0, "noise_draws": 2}
    sent, caps = stream_rx.captures(std_dvbt, t, 2**33 + 7, "cpu")
    sent2, caps2 = stream_rx.captures(std_dvbt, t, 2**33 + 7, "cpu")
    assert np.array_equal(sent, sent2) and np.array_equal(caps[1], caps2[1])
    assert not np.array_equal(caps[0], caps[1])
    assert caps[0].dtype == np.complex64
    clean = std_dvbt.capture(torch.from_numpy(sent)).numpy()
    snr = 10 * np.log10(np.mean(np.abs(clean) ** 2)
                        / np.mean(np.abs(caps[0] - clean) ** 2))
    assert abs(snr - 20.0) < 0.02
