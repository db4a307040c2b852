"""Worker process for tests/test_torch_parallel.py: one rank of a gloo CPU
process group that runs the port's sequence-sharded modulators.  It imports
no JAX.

    python tests/torch_parallel_worker.py RANK WORLD INIT_METHOD DIR CASE...

For each CASE (a key of ``CASES``) it reads only its own stripe of
``DIR/CASE.ts`` (``multihost.host_block_range``, a memory map), uploads it
(``make_local_blocks``), runs the sharded modulator and writes
``local_output``'s first block and data to ``DIR/CASE.RANK.npz`` together
with the byte range it read.
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _cases():
    from dtv_utils_torch.core.config import (CodeRate, Constellation,
                                             DvbtConfig, GuardInterval,
                                             J83bConfig, TransmissionMode)
    from dtv_utils_torch.models.dvbt2 import PROFILES
    from dtv_utils_torch.parallel import stream
    from dtv_utils_torch.tx import j83b as txq

    M, C, R, G = (TransmissionMode, Constellation, CodeRate, GuardInterval)
    dvbt = DvbtConfig(mode=M.M2K, bandwidth_mhz=6, constellation=C.QPSK,
                      code_rate=R.R1_2, guard=G.G1_4)
    dvbt64 = DvbtConfig(mode=M.M2K, bandwidth_mhz=8, constellation=C.QAM64,
                        code_rate=R.R3_4, guard=G.G1_8)
    blade = PROFILES["blade"]
    return {
        "dvbt": (stream.sharded_dvbt_modulator(dvbt),
                 dvbt.ts_bytes_per_superframe),
        "dvbt64": (stream.sharded_dvbt_modulator(dvbt64),
                   dvbt64.ts_bytes_per_superframe),
        "dvbt2": (stream.sharded_dvbt2_modulator(blade),
                  blade.payload_bytes_per_frame),
        "j83b": (stream.sharded_j83b_modulator(J83bConfig()),
                 txq.SUPERBLOCK_BYTES),
    }


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_method, out_dir = sys.argv[3], pathlib.Path(sys.argv[4])
    names = sys.argv[5:]

    import torch
    import torch.distributed as dist

    from dtv_utils_torch.parallel import multihost as mh

    torch.set_num_threads(2)
    dev = mh.initialize(init_method, world, rank, device="cpu")
    try:
        cases = _cases()
        for name in names:
            run, blk = cases[name]
            data = np.memmap(out_dir / f"{name}.ts", dtype=np.uint8, mode="r")
            n_blocks = len(data) // blk
            start, stop = mh.host_block_range(n_blocks)
            local = np.array(data[start * blk:stop * blk]).reshape(-1, blk)
            del data
            out = run(mh.make_local_blocks(local, n_blocks, device=dev))
            first, host = mh.local_output(out)
            np.savez(out_dir / f"{name}.{rank}.npz", first=first, iq=host,
                     read=np.array([start * blk, stop * blk]))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"TORCH_PARALLEL_OK rank={rank} world={world} cases={names}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
