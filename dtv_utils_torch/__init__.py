"""PyTorch/CUDA port of ``dtv_utils_tpu``, for one NVIDIA Hopper GPU.

The JAX package beside it is the reference: every module here mirrors the
path of its counterpart there (``dtv_utils_torch/tx/j83b.py`` ports
``dtv_utils_tpu/tx/j83b.py``), and ``tests/test_torch_*.py`` hold the two
to the same outputs.  This package imports torch and numpy only, never JAX.

Idiom: plain functions on tensors, run eagerly; stream state is a
``@dataclass`` of tensors; public entry points take an explicit ``device``
(see :func:`resolve_device` — a CUDA request never falls back to the CPU).
Every module of the JAX package has its counterpart here, but for the TPU
workarounds.  The one hand-written kernel is the J.83B RRC interpolator
(``csrc/fir_interp2.cu``, wrapped by ``ops/fir.py``), the port of the JAX
package's one Pallas kernel.  The rate oracles are copies, the native
stream analyzers are the repository's C++ under ``native/``, built by
``analysis/native.py``, and ``utils/profile.py`` scores each chain stage
against the card's roofline.
"""

from dtv_utils_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
