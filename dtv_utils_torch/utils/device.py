"""Explicit device selection.

The JAX package pins its platform once per process (``tests/conftest.py``,
``DTV_PLATFORM`` in ``cli/__main__.py``).  The port instead takes a device on
every public entry point and parses it here.  Asking for CUDA where there is
none is an error: nothing falls back to the CPU.
"""

from __future__ import annotations

import subprocess

import torch

from dtv_utils_torch.utils.trace import span


def resolve_device(device: str | torch.device) -> torch.device:
    """Parse ``"cpu"``, ``"cuda"``, ``"cuda:N"`` or a ``torch.device``.

    A CUDA device comes back with its index filled in (``cuda`` → the
    current device), so it compares equal to ``tensor.device`` and can key
    the per-device constant caches.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but "
                "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(
            f"unsupported device {str(device)!r}: use 'cpu' or 'cuda[:N]'")
    return dev


def card_line(dev: torch.device) -> str:
    """``name, power limit`` of CUDA device ``dev``, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reports them: a
    card may be set below its maximum power, and then runs slower."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[dev.index]


def split_device_arg(argv: list[str]) -> tuple[list[str], str]:
    """Take ``--device DEV`` / ``--device=DEV`` out of a CLI's argv
    (default ``cuda``)."""
    rest, device = [], "cuda"
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, "")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, device


# The memory policy of the stages that run in passes: a pass takes as many
# units of work as ``working_bytes`` holds at the stage's bytes per unit.
# Each size is the device peak per unit (temporaries and output above the
# stage's input) that ``chip_smoke.check_pass_units`` reads at the DVB-T
# flagship's 2 and 8 superframes per call, with about a quarter added for
# other configs; that check fails if a peak outgrows its size.  Measured
# on an NVIDIA H100 80GB HBM3 (700 W): 118.4 (front end), 56,804 (RS) and,
# with the Viterbi kernels' packed decisions, 32.0 bytes.  The Viterbi's
# plain version (bool decisions, on the CPU) is sized from the resident
# peak that ``tools/viterbi_plain_peak.py`` reads on the host at 200 and
# 400 blocks: 111.5 bytes.
CPU_WORKING_BYTES = 1 << 30
FRONT_BYTES_PER_SAMPLE = 160       # rx.dvbt front end, per IQ sample
VITERBI_BYTES_PER_STEP = 40        # ops.viterbi kernels, per trellis step
VITERBI_PLAIN_BYTES_PER_STEP = 140  # its plain version, per trellis step
RS_BYTES_PER_PACKET = 72 << 10     # rx.dvbt.decode_outer, per TS packet


@span("dtv.sizing")
def working_bytes(device: torch.device) -> int:
    """Bytes a call may spend on temporaries that it can cut into passes.

    On the card: half of what the caching allocator can still hand out,
    the smaller of the card's free memory plus the allocator's cached
    blocks and the ``set_per_process_memory_fraction`` cap less what is
    reserved (``mem_get_info`` ignores that cap).  On the CPU a fixed
    ``CPU_WORKING_BYTES``."""
    if device.type != "cuda":
        return CPU_WORKING_BYTES
    free, total = torch.cuda.mem_get_info(device)
    reserved = torch.cuda.memory_reserved(device)
    cached = reserved - torch.cuda.memory_allocated(device)
    cap = int(torch.cuda.get_per_process_memory_fraction(device) * total)
    return max(min(free + cached, cap - reserved), 0) // 2


def units_per_pass(device: torch.device, unit_bytes: int) -> int:
    """Units of ``unit_bytes`` each that one pass may hold (at least 1)."""
    return max(1, working_bytes(device) // unit_bytes)
