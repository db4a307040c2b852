"""The port's captured calls (``utils/graph``) on the card: capture, replay
on new inputs (DVB-T2 with tone reservation among them), kernel launches
counted per replay, tables evicted from their caches between capture and
replay.  Every test needs a CUDA device
and skips without one.  The module imports no JAX (the GPU machine has
none): there, run ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_graph_gpu.py -m gpu``.  The comparisons with the JAX
reference are in ``tests/test_torch_graph.py``.

Each graph is held to the eager chain on the card bit for bit: the same
kernels run in the same order on the same inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dtv_utils_torch.core.config import (CodeRate, Constellation, Dvbt2Config,
                                         DvbtConfig, GuardInterval,
                                         J83bConfig, T2FrameSize,
                                         TransmissionMode)
from dtv_utils_torch.models.dvbt2 import PROFILES
from dtv_utils_torch.ops import _build, fir
from dtv_utils_torch.ops import ldpc_decode as TLD
from dtv_utils_torch.parallel import stream as S
from dtv_utils_torch.tx import dvbt as txd
from dtv_utils_torch.tx import dvbt2 as txt2
from dtv_utils_torch.tx import j83b as txq
from dtv_utils_torch.utils import graph

CFG = DvbtConfig(mode=TransmissionMode.M2K, bandwidth_mhz=6,
                 constellation=Constellation.QPSK, code_rate=CodeRate.R1_2,
                 guard=GuardInterval.G1_4)
CHAINS = {"dvbt": (txd, CFG, txd.modulate_superframe,
                   CFG.ts_bytes_per_superframe),
          "dvbt2": (txt2, PROFILES["blade"], txt2.modulate_frame,
                    PROFILES["blade"].payload_bytes_per_frame),
          "dvbt2-tr": (txt2, dataclasses.replace(PROFILES["blade"],
                                                 papr_tr=True),
                       txt2.modulate_frame,
                       PROFILES["blade"].payload_bytes_per_frame),
          "j83b": (txq, J83bConfig(), txq.modulate_superblock,
                   txq.SUPERBLOCK_BYTES)}
CALLS = 3
FIR_TOL = dict(atol=1e-6, rtol=1e-6)   # kernel vs plain: fp32 sums reordered


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _ts(n_bytes: int, seed: int, dev) -> torch.Tensor:
    ts = np.random.default_rng(seed).integers(0, 256, n_bytes).astype(
        np.uint8)
    ts[::188] = 0x47
    return torch.from_numpy(ts).to(dev)


def _fields(state) -> list[torch.Tensor]:
    return [getattr(state, f.name) for f in dataclasses.fields(state)]


@pytest.mark.gpu
@pytest.mark.parametrize("chain", list(CHAINS))
def test_jit_modulator_replays_equal_eager(chain):
    """Three calls (the first captures, two replay on new inputs) equal the
    eager chain bit for bit, state included (with tone reservation, its
    ``_tr_step`` loop inside the graph); J.83B's FIR kernel is launched
    once per call, replays included."""
    dev = _cuda()
    mod, cfg, eager, blk = CHAINS[chain]
    ts = _ts(CALLS * blk, 5, dev)
    fn = mod.jit_modulator(cfg, device=dev)
    st = est = mod.init_state(cfg, device=dev)
    for i in range(CALLS):
        x = ts[i * blk:(i + 1) * blk]
        launches = _build.LAUNCHES["fir_interp2"]
        iq, st = fn(x, st)
        if chain == "j83b":
            assert _build.LAUNCHES["fir_interp2"] - launches == 1
        want, est = eager(cfg, x, est)
        assert torch.equal(iq, want), (chain, i)
        for a, b in zip(_fields(st), _fields(est)):
            assert torch.equal(a, b), (chain, i)
    assert fn.static_call(x, st).graph is not None


@pytest.mark.gpu
def test_one_fir_launch_captured_and_replayed():
    """One FIR launch captured (its taps a by-value parameter) and replayed
    on new cells and a new history: each replay equals the eager kernel
    bit for bit and the plain version within FIR_TOL, and adds one launch
    to the counter."""
    dev = _cuda()
    taps = txq.rrc_taps(J83bConfig())
    n = 40_000
    g = torch.Generator(device=dev).manual_seed(7)
    sc = graph.StaticCall(
        lambda tail, cells: fir.polyphase_interp2_split(tail, cells, taps),
        (torch.empty(2, fir.HIST, device=dev), torch.empty(2, n, device=dev)),
        device=dev)
    for i in range(3):
        tail = torch.randn(2, fir.HIST, generator=g, device=dev)
        cells = torch.randn(2, n, generator=g, device=dev)
        launches = _build.LAUNCHES["fir_interp2"]
        got = sc(tail, cells)
        assert _build.LAUNCHES["fir_interp2"] - launches == 1
        assert torch.equal(got, fir.polyphase_interp2_split(tail, cells,
                                                           taps))
        want = fir.interp2_reference(torch.cat([tail, cells], 1).cpu(),
                                     taps, n)
        torch.testing.assert_close(got.cpu(), want, **FIR_TOL)
    assert sc.launches == {"fir_interp2": 1}


@pytest.mark.gpu
def test_replay_after_tables_leave_their_caches():
    """The bounded caches (DVB-T's dispersal rows, DVB-T2's stream plan)
    are cleared between capture and replay and their memory handed out
    again: the graph still reads the tables it was captured on."""
    dev = _cuda()
    for chain in ("dvbt", "dvbt2"):
        mod, cfg, eager, blk = CHAINS[chain]
        ts = _ts(2 * blk, 9, dev)
        fn = mod.jit_modulator(cfg, device=dev)
        st0 = mod.init_state(cfg, device=dev)
        fn(ts[:blk], st0)
        txd.dispersal_rows.cache_clear()
        txt2._stream_plan.cache_clear()
        junk = [torch.full((1 << 20,), 0xA5, dtype=torch.uint8, device=dev)
                for _ in range(64)]
        iq, _ = fn(ts[blk:], st0)
        want, _ = eager(cfg, ts[blk:], st0)
        assert torch.equal(iq, want), chain
        del junk


@pytest.mark.gpu
def test_batched_runner_replays_take_the_device_index():
    """A captured batched call replayed with another start_idx (a 0-d
    int32 tensor) takes that call's phase, not the first one's."""
    dev = _cuda()
    blk = CFG.ts_bytes_per_superframe
    ts = _ts(6 * blk, 11, dev).reshape(6, blk)
    fn = S.batched_dvbt_modulator(CFG, device=dev)
    halo = S.HALO_PACKETS * 188
    got = [fn(ts[i:i + 2], ts[i - 1, -halo:] if i else None,
              S.block_index(i, dev)) for i in (0, 2, 4)]
    zeros = torch.zeros(halo, dtype=torch.uint8, device=dev)
    want = [S.modulate_dvbt_blocks(CFG, ts[i:i + 2],
                                   ts[i - 1, -halo:] if i else zeros,
                                   S.block_index(i, dev))
            for i in (0, 2, 4)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_jit_decode_replays_equal_decode():
    """A small batch: hard bits and ok equal ``decode``'s on two calls;
    each replay adds 30 check and 31 variable launches."""
    dev = _cuda()
    cfg = Dvbt2Config(frame_size=T2FrameSize.SHORT, fec_blocks=3,
                      ti_blocks=1)
    g = torch.Generator(device=dev).manual_seed(3)
    fn = TLD.jit_decode(cfg, 30, device=dev)
    for _ in range(2):
        llr = 4 * torch.randn(3, cfg.nldpc, generator=g, device=dev)
        before = dict(_build.LAUNCHES)
        hard, ok = fn(llr)
        assert _build.LAUNCHES == before | {
            "ldpc_check": before["ldpc_check"] + 30,
            "ldpc_variable": before["ldpc_variable"] + 31}
        want_hard, want_ok = TLD.decode(cfg, llr, 30)
        assert torch.equal(hard, want_hard) and torch.equal(ok, want_ok)


@pytest.mark.gpu
def test_capture_refuses_another_tf32_setting():
    dev = _cuda()
    sc = graph.StaticCall(lambda x: x @ x, (torch.eye(8, device=dev),),
                          device=dev)
    sc(torch.eye(8, device=dev))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = not saved
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            sc(torch.eye(8, device=dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
