"""FFTs for the OFDM back ends and front ends (counterpart of
``dtv_utils_tpu/ops/cfft.py``).

The reference built its DFT from matmuls on float32 re/im pairs because its
TPU backend had no FFT and no complex dtype.  CUDA has both, so this is
``torch.fft`` (cuFFT on the card, pocketfft on the CPU) on complex64, with
the FFTW ``fft_vcc`` convention the reference chains are calibrated to:
unnormalized transforms in both directions.
"""

from __future__ import annotations

import torch

IFFT_MAX_ROWS = {32768: 127}
"""Rows per cuFFT call, by length.  cuFFT (CUDA 12.8, H100) plans a batch
of 128 or more 32768-point rows differently from a smaller batch, and the
two plans round differently; below that, and at every length up to 16384
at every batch tried, a row's result does not depend on the batch or its
place in it (``tools/cufft_batch_probe.py``).  Cutting a long batch on the
card into calls of at most this many rows keeps each row's bits
independent of how many frames a call holds, so a batched modulator equals
the serial one bit for bit.  (On the CPU, pocketfft rounds differently
only in batches of at most 4 rows, and every frame here has more: 60 to
272 symbols.)"""


def ifft_unnormalized(x: torch.Tensor) -> torch.Tensor:
    """complex64 [..., n] → Σ_k x[k]·exp(+2πi·jk/n) along the last axis
    (numpy.fft.ifft times n); on the card in calls of at most
    ``IFFT_MAX_ROWS[n]`` rows."""
    if x.dtype != torch.complex64:
        raise TypeError(f"need complex64, got {x.dtype}")
    rows = IFFT_MAX_ROWS.get(x.shape[-1]) if x.is_cuda else None
    if rows is None or x.numel() <= rows * x.shape[-1]:
        return torch.fft.ifft(x, dim=-1, norm="forward")
    return _ifft_in_calls(x, rows)


def _ifft_in_calls(x: torch.Tensor, rows: int) -> torch.Tensor:
    """The unnormalized inverse FFT of ``x`` in calls of at most ``rows``
    rows, written in place into one output."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(flat)
    for src, dst in zip(flat.split(rows), out.split(rows)):
        torch.fft.ifft(src, dim=-1, norm="forward", out=dst)
    return out.reshape(x.shape)


def fft_unnormalized(x: torch.Tensor) -> torch.Tensor:
    """complex64 [..., n] → Σ_k x[k]·exp(−2πi·jk/n) along the last axis
    (numpy.fft.fft; the reference's ``fft_pairs(x, sign=-1)``)."""
    if x.dtype != torch.complex64:
        raise TypeError(f"need complex64, got {x.dtype}")
    return torch.fft.fft(x, dim=-1, norm="backward")


def ifftshift(x: torch.Tensor) -> torch.Tensor:
    """numpy.fft.ifftshift along the last axis."""
    return torch.fft.ifftshift(x, dim=-1)
