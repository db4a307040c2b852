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


def ifft_unnormalized(x: torch.Tensor) -> torch.Tensor:
    """complex64 [..., n] → Σ_k x[k]·exp(+2πi·jk/n) along the last axis
    (numpy.fft.ifft times n)."""
    if x.dtype != torch.complex64:
        raise TypeError(f"need complex64, got {x.dtype}")
    return torch.fft.ifft(x, dim=-1, norm="forward")


def fft_unnormalized(x: torch.Tensor) -> torch.Tensor:
    """complex64 [..., n] → Σ_k x[k]·exp(−2πi·jk/n) along the last axis
    (numpy.fft.fft; the reference's ``fft_pairs(x, sign=-1)``)."""
    if x.dtype != torch.complex64:
        raise TypeError(f"need complex64, got {x.dtype}")
    return torch.fft.fft(x, dim=-1, norm="backward")


def ifftshift(x: torch.Tensor) -> torch.Tensor:
    """numpy.fft.ifftshift along the last axis."""
    return torch.fft.ifftshift(x, dim=-1)
