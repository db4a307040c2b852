"""Entry points of the port (counterpart of ``__graft_entry__.py``).

entry():             one flagship superframe (DVB-T 8K 64-QAM 7/8 GI 1/32)
                     as (fn, example_args), on the card unless the caller
                     asks for the CPU.
dryrun_multichip(n): one sharded step of each modulator (DVB-T, DVB-T2,
                     J.83B) over a process group of n ranks, one block per
                     rank, held to the one-device batched path bit for
                     bit: NCCL with one card per rank, or gloo on the CPU.
                     The ranks are Python processes started here, which
                     meet at a file rendezvous in a temporary directory.

``python -m dtv_utils_torch.entry [--device cpu] [-n N]`` runs both.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

DRYRUN_TIMEOUT_S = 900
_RANK_CODE = ("import sys; from dtv_utils_torch.entry import _dryrun_rank; "
              "_dryrun_rank(int(sys.argv[1]), int(sys.argv[2]), "
              "*sys.argv[3:])")


def _flagship_cfg():
    from dtv_utils_torch.core.config import (CodeRate, Constellation,
                                             DvbtConfig, GuardInterval,
                                             TransmissionMode)
    return DvbtConfig(mode=TransmissionMode.M8K, bandwidth_mhz=8,
                      constellation=Constellation.QAM64,
                      code_rate=CodeRate.R7_8, guard=GuardInterval.G1_32)


def _ts(n_blocks: int, block_bytes: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, size=(n_blocks, block_bytes), dtype=np.uint8)
    ts[:, ::188] = 0x47
    return ts


def entry(device="cuda"):
    """(fn, example_args): ``fn(*example_args)`` modulates one flagship
    superframe of seeded TS on ``device`` and returns (IQ, next state)."""
    from dtv_utils_torch.tx import dvbt as txd
    from dtv_utils_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = _flagship_cfg()
    ts = _ts(1, cfg.ts_bytes_per_superframe, 0).reshape(-1)
    fn = functools.partial(txd.modulate_superframe, cfg)
    return fn, (torch.from_numpy(ts).to(dev), txd.init_state(cfg, device=dev))


def _dryrun_rank(rank: int, n: int, init_method: str, device_type: str):
    """One rank of ``dryrun_multichip``: every sharded modulator on one
    block per rank of a seeded stream, equal bit for bit to the one-device
    batched path's block ``rank`` of the same stream (run on this rank's
    device), finite and of the expected shape."""
    import torch.distributed as dist

    from dtv_utils_torch.core.config import (CodeRate, Constellation,
                                             Dvbt2Config, DvbtConfig,
                                             GuardInterval, J83bConfig,
                                             TransmissionMode)
    from dtv_utils_torch.parallel import multihost, stream
    from dtv_utils_torch.tx import j83b as txq

    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    dev = multihost.initialize(init_method, n, rank, device=device)
    try:
        cfg = DvbtConfig(mode=TransmissionMode.M2K, bandwidth_mhz=6,
                         constellation=Constellation.QPSK,
                         code_rate=CodeRate.R1_2, guard=GuardInterval.G1_4)
        cfg2, cfgq = Dvbt2Config(), J83bConfig()

        def j83b_batched(x):
            iq, _ = txq.modulate_superblock(
                cfgq, x.reshape(-1), txq.init_state(cfgq, device=dev))
            return iq.reshape(2, x.shape[0], -1).transpose(0, 1)
        cases = [   # (name, sharded, batched from block 0, block bytes)
            ("dvbt", stream.sharded_dvbt_modulator(cfg),
             lambda x: stream.batched_dvbt_modulator(cfg, device=dev)(
                 x, None, 0), cfg.ts_bytes_per_superframe),
            ("dvbt2", stream.sharded_dvbt2_modulator(cfg2),
             lambda x: stream._batched_dvbt2_modulator(cfg2, device=dev)(
                 x, None, 0), cfg2.payload_bytes_per_frame),
            ("j83b", stream.sharded_j83b_modulator(cfgq), j83b_batched,
             txq.SUPERBLOCK_BYTES),
        ]
        for seed, (name, sharded, batched, blk) in enumerate(cases, 1):
            ts = torch.from_numpy(_ts(n, blk, seed)).to(dev)
            iq = sharded(ts[rank:rank + 1])
            want = batched(ts[:rank + 1])[rank:]
            if not torch.equal(iq, want):
                raise AssertionError(f"rank {rank}: sharded {name} differs "
                                     "from the batched path")
            if not bool(torch.isfinite(torch.view_as_real(iq)
                                       if iq.is_complex() else iq).all()):
                raise AssertionError(f"rank {rank}: non-finite {name}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run one sharded step of each modulator over ``n_devices`` ranks,
    each a new Python process: with ``device="cuda"`` rank r uses card r
    (more ranks than cards raise), with ``"cpu"`` every rank is a gloo CPU
    process.  Raises if any rank fails; stops every rank it started."""
    from dtv_utils_torch.parallel import multihost
    from dtv_utils_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"need at least one rank, got {n_devices}")
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks but "
                         f"{torch.cuda.device_count()} CUDA devices")
    try:
        multihost.run_ranks(_RANK_CODE, n_devices, [dev.type],
                            timeout=DRYRUN_TIMEOUT_S)
    except RuntimeError as e:
        raise RuntimeError(f"dryrun_multichip({n_devices}): {e}") from None


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-n", type=int, default=1, help="ranks (default 1)")
    args = ap.parse_args()
    fn, example = entry(args.device)
    iq, _ = fn(*example)
    print(f"entry ok: {tuple(iq.shape)} {iq.dtype} on {iq.device}")
    dryrun_multichip(args.n, args.device)
    print(f"dryrun_multichip({args.n}) ok")
