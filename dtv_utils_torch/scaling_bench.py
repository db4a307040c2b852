"""Scaling harness of the port: Msamples/s of the sequence-sharded DVB-T
modulator (``parallel/stream.sharded_dvbt_modulator``) at 1..N ranks, the
counterpart of ``scaling_bench.py``.

Every row is one self-describing JSON line on stdout: it names the
hardware it ran on and how its efficiency is normalized, so it can be read
without this docstring.  Every rank is a Python process of a
``torch.distributed`` group (``parallel/multihost.run_ranks``); the config
is ``scaling_bench.py``'s, 2K 64-QAM 3/4 GI 1/8 at 8 MHz, with 2
superframes per rank per call, ``ROUNDS`` calls on distinct inputs of
which the first ``WARMUP`` are not timed.  Two row families:

* ``"hardware": "cpu-gloo"`` (``--cpu``): 1, 2 and 4 gloo ranks on this
  host, the world's ranks pinned one to a core over min(n, ncores) cores,
  one thread each, timed by rank 0's host clock.  This shows that the
  sharded program scales STRUCTURALLY (no serial dependency, collectives
  only for the KB-scale halo); efficiency is per core against the 1-rank
  row, whose ideal speedup at n ranks is min(n, ncores).  On a small host
  the curve saturates at ncores: that is the HOST's core ceiling, not the
  program's scaling limit.  It takes the place of the reference's
  ``cpu-sim`` (virtual devices of one process) and ``multihost`` rows.
* ``"hardware": "gpu"`` (``--gpu``, the default): NCCL ranks, one card
  each, timed by CUDA events on rank 0, with the card's kind and power
  limit.  World 1 always; worlds 2 and 4 only where
  ``torch.cuda.device_count()`` holds them, and otherwise one stderr line
  says that no such machine was found (no row is invented).

``python -m dtv_utils_torch.scaling_bench [--cpu] [--gpu] [--worlds
1,2,4]``.  ``--gpu`` without a card raises and prints no row.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

BLOCKS_PER_RANK = 2
ROUNDS, WARMUP = 10, 2
WORLDS = (1, 2, 4)
RANK_TIMEOUT_S = 600
_CPU_NOTE = ("efficiency is per core (rank r pinned to core r mod "
             "min(n, ncores), one thread each); saturation at ncores is the "
             "host ceiling, not the program")
_RANK_CODE = ("import sys; from dtv_utils_torch.scaling_bench import "
              "_rank; _rank(int(sys.argv[1]), int(sys.argv[2]), "
              "*sys.argv[3:])")


def _cfg():
    from dtv_utils_torch.core.config import (CodeRate, Constellation,
                                             DvbtConfig, GuardInterval,
                                             TransmissionMode)
    return DvbtConfig(mode=TransmissionMode.M2K, bandwidth_mhz=8,
                      constellation=Constellation.QAM64,
                      code_rate=CodeRate.R3_4, guard=GuardInterval.G1_8)


def _rank(rank: int, world: int, init_method: str, device_type: str,
          cpus: str = "") -> None:
    """One rank: ROUNDS calls of the sharded modulator on this rank's
    stripe of seeded TS, WARMUP of them untimed; rank 0 prints
    {"msps": ...} over the timed calls of the whole world."""
    import torch.distributed as dist

    from dtv_utils_torch.parallel import multihost, stream
    from dtv_utils_torch.utils import timing

    if device_type == "cpu":
        pool = [int(c) for c in cpus.split(",")]
        os.sched_setaffinity(0, {pool[rank % len(pool)]})
        torch.set_num_threads(1)
    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    dev = multihost.initialize(init_method, world, rank, device=device)
    try:
        cfg = _cfg()
        blk = cfg.ts_bytes_per_superframe
        n_blocks = BLOCKS_PER_RANK * world
        start, stop = multihost.host_block_range(n_blocks)
        rng = np.random.default_rng(0)
        inputs = []
        for _ in range(ROUNDS):
            ts = rng.integers(0, 256, (n_blocks, blk), dtype=np.uint8)
            ts[:, ::188] = 0x47
            inputs.append(multihost.make_local_blocks(ts[start:stop],
                                                      n_blocks, device=dev))
        run = stream.sharded_dvbt_modulator(cfg)
        for x in inputs[:WARMUP]:
            run(x)
        dist.barrier()

        def timed():
            for x in inputs[WARMUP:]:
                run(x)
        sec = timing.elapsed_s(timed, dev)
        if rank == 0:
            samples = (ROUNDS - WARMUP) * n_blocks * cfg.samples_per_superframe
            print(json.dumps({"msps": samples / sec / 1e6}), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _measure(world: int, device_type: str, cpus: list[int] = ()) -> float:
    from dtv_utils_torch.parallel import multihost

    outs = multihost.run_ranks(
        _RANK_CODE, world, [device_type, ",".join(map(str, cpus))],
        timeout=RANK_TIMEOUT_S)
    return json.loads(outs[0].strip().splitlines()[-1])["msps"]


def cpu_rows(worlds=WORLDS) -> list[dict]:
    """gloo rows at each world size; efficiency against the 1-rank row
    (None where the 1-rank row was not run)."""
    pool = sorted(os.sched_getaffinity(0))
    ncores = len(pool)
    rows, base = [], None
    for n in worlds:
        cores = min(n, ncores)
        msps = _measure(n, "cpu", pool[:cores])
        if n == 1:
            base = msps
        row = {"hardware": "cpu-gloo", "world": n, "cores": cores,
               "host_cores": ncores,
               "blocks_per_rank": BLOCKS_PER_RANK, "msps": msps,
               "efficiency_per_core": (None if base is None
                                       else msps / (base * cores)),
               "note": _CPU_NOTE}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def gpu_rows(worlds=WORLDS) -> list[dict]:
    """NCCL rows at each world size the machine's cards hold; one stderr
    line for each that it does not.  Raises without a card."""
    from dtv_utils_torch.utils.device import card_line, resolve_device

    dev = resolve_device("cuda:0")
    kind = torch.cuda.get_device_name(dev)
    power_limit = card_line(dev).rsplit(",", 1)[-1].strip()
    count = torch.cuda.device_count()
    rows = []
    for n in worlds:
        if n > count:
            print(f"scaling_bench: world {n} needs {n} cards; this machine "
                  f"has {count}: no machine with {n} cards was found, no row",
                  file=sys.stderr, flush=True)
            continue
        row = {"hardware": "gpu", "world": n, "device_kind": kind,
               "power_limit": power_limit, "cards": count,
               "blocks_per_rank": BLOCKS_PER_RANK, "rounds": ROUNDS,
               "warmup": WARMUP, "msps": _measure(n, "cuda"),
               "note": "NCCL, one card per rank; CUDA events on rank 0"}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dtv_utils_torch.scaling_bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="gloo rows")
    ap.add_argument("--gpu", action="store_true",
                    help="NCCL rows (the default)")
    ap.add_argument("--worlds", default=",".join(map(str, WORLDS)),
                    help="world sizes, comma-separated (default 1,2,4)")
    args = ap.parse_args(argv)
    worlds = [int(w) for w in args.worlds.split(",")]
    if args.cpu:
        cpu_rows(worlds)
    if args.gpu or not args.cpu:
        gpu_rows(worlds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
