"""The port's batched and sharded streaming on the card, held to the port's
own serial chain on the card.  Every test needs a CUDA device and skips
without one.  The module imports no JAX (the GPU machine has none): there,
run ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_parallel_gpu.py -m gpu``.  The JAX comparisons and the
gloo runs are in ``tests/test_torch_parallel.py``.

Small configs: DVB-T 2K QPSK 1/2, DVB-T2 blade, J.83B.  Batched output must
equal serial output bit for bit; the sharded path runs at world size 1 in
an NCCL process group (file rendezvous in ``tmp_path``).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dtv_utils_torch.core import cplx
from dtv_utils_torch.core.config import (CodeRate, Constellation, DvbtConfig,
                                         GuardInterval, J83bConfig,
                                         TransmissionMode)
from dtv_utils_torch.models.dvbt2 import PROFILES
from dtv_utils_torch.ops import _build, cfft
from dtv_utils_torch.parallel import multihost as MH
from dtv_utils_torch.parallel import stream as S
from dtv_utils_torch.tx import dvbt as txd
from dtv_utils_torch.tx import dvbt2 as txt2
from dtv_utils_torch.tx import j83b as txq

CFG = DvbtConfig(mode=TransmissionMode.M2K, bandwidth_mhz=6,
                 constellation=Constellation.QPSK, code_rate=CodeRate.R1_2,
                 guard=GuardInterval.G1_4)
BLADE = PROFILES["blade"]
J83B = J83bConfig()


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _ts(n_bytes: int, seed: int) -> np.ndarray:
    ts = np.random.default_rng(seed).integers(0, 256, n_bytes).astype(
        np.uint8)
    ts[::188] = 0x47
    return ts


@pytest.mark.gpu
def test_batched_dvbt_cuda_equals_serial():
    dev = _cuda()
    blk = CFG.ts_bytes_per_superframe
    ts = _ts(6 * blk, 1)
    want, _ = txd.modulate_stream(CFG, ts, device=dev)
    fn = S.batched_dvbt_modulator(CFG, device=dev)
    x = torch.from_numpy(ts).to(dev).reshape(6, blk)
    got = torch.cat([fn(x[:4], None, 0),
                     fn(x[4:], x[3, -S.HALO_PACKETS * 188:], 4)])
    np.testing.assert_array_equal(got.cpu().numpy().reshape(-1), want)


@pytest.mark.gpu
def test_batched_dvbt2_cuda_equals_serial():
    dev = _cuda()
    blk = BLADE.payload_bytes_per_frame
    ts = _ts(3 * blk, 2)
    want, _ = txt2.modulate_stream(BLADE, ts, device=dev)
    got = S._batched_dvbt2_modulator(BLADE, device=dev)(
        torch.from_numpy(ts).to(dev).reshape(3, blk), None, 0)
    np.testing.assert_array_equal(got.cpu().numpy().reshape(-1), want)


@pytest.mark.gpu
def test_batched_j83b_cuda_equals_serial_in_one_fir_launch():
    dev = _cuda()
    ts = _ts(2 * txq.SUPERBLOCK_BYTES, 3)
    want, _ = txq.modulate_stream(J83B, ts, device=dev)
    launches = _build.LAUNCHES["fir_interp2"]
    iq, _ = txq.modulate_superblock(J83B, torch.from_numpy(ts).to(dev),
                                    txq.init_state(J83B, device=dev))
    assert _build.LAUNCHES["fir_interp2"] - launches == 1
    np.testing.assert_array_equal(cplx.rails_to_np(iq), want)


@pytest.mark.gpu
def test_ifft_rows_do_not_depend_on_the_batch():
    """32K rows in one call of 240 (cut into calls of at most 127) equal
    the same rows in calls of 60, as one BBC frame's symbols go."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.complex(torch.randn(240, 32768, generator=g, device=dev),
                      torch.randn(240, 32768, generator=g, device=dev))
    want = torch.cat([cfft.ifft_unnormalized(c) for c in x.split(60)])
    assert torch.equal(cfft.ifft_unnormalized(x), want)


@pytest.mark.gpu
def test_sharded_world1_nccl_equals_batched(tmp_path):
    dev = _cuda()
    blk, blk2 = CFG.ts_bytes_per_superframe, BLADE.payload_bytes_per_frame
    x = torch.from_numpy(_ts(2 * blk, 5)).to(dev).reshape(2, blk)
    x2 = torch.from_numpy(_ts(2 * blk2, 6)).to(dev).reshape(2, blk2)
    xq = torch.from_numpy(_ts(txq.SUPERBLOCK_BYTES, 7)).to(dev).reshape(1, -1)
    MH.initialize((tmp_path / "rdv").as_uri(), 1, 0, device=dev)
    try:
        assert dist.get_backend() == "nccl"
        assert torch.equal(S.sharded_dvbt_modulator(CFG)(x),
                           S.batched_dvbt_modulator(CFG, device=dev)(
                               x, None, 0))
        assert torch.equal(S.sharded_dvbt2_modulator(BLADE)(x2),
                           S._batched_dvbt2_modulator(BLADE, device=dev)(
                               x2, None, 0))
        want, _ = txq.modulate_superblock(J83B, xq.reshape(-1),
                                          txq.init_state(J83B, device=dev))
        assert torch.equal(S.sharded_j83b_modulator(J83B)(xq)[0], want)
        with pytest.raises(RuntimeError, match="gloo"):
            S._check_backend(None, torch.device("cpu"))
    finally:
        dist.destroy_process_group()
