"""Explicit device selection.

The JAX package pins its platform once per process (``tests/conftest.py``,
``DTV_PLATFORM`` in ``cli/__main__.py``).  The port instead takes a device on
every public entry point and parses it here.  Asking for CUDA where there is
none is an error: nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


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
