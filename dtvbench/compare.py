"""The comparisons that decide ``correct``, shared by the drivers."""

from __future__ import annotations

import contextlib

import torch


def iq_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Widest gap of the program's IQ from the reference's, over the
    reference's RMS; infinite where the shapes differ."""
    got = got.reshape(-1)
    if got.shape != want.shape:
        return float("inf")
    rms = want.abs().square().mean().sqrt()
    return float((got.to(want.dtype) - want).abs().max() / rms)


class Tap:
    """What one stage of the program returns in the calls that are
    checked.  ``patch(module, name)`` wraps ``module.name`` for a
    with-block; while ``on`` is true every value it returns is kept, and
    ``take()`` hands the call's values over, joined."""

    def __init__(self):
        self.on = False
        self.kept: list[torch.Tensor] = []

    @contextlib.contextmanager
    def patch(self, module, name: str):
        orig = getattr(module, name)

        def tapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            if self.on:
                self.kept.append(out)
            return out

        setattr(module, name, tapped)
        try:
            yield self
        finally:
            setattr(module, name, orig)

    def take(self) -> torch.Tensor | None:
        out, self.kept = self.kept, []
        if not out:
            return None
        return out[0] if len(out) == 1 else torch.cat(out)
