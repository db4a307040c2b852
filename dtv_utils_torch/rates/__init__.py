"""Rate oracles of the port (copies of ``dtv_utils_tpu/rates/``, pure
Python: the reference's package ``__init__`` imports JAX through its
parent, so the modules are copied, not imported).

Each module computes whole parameter sweeps as vectorized array programs and
also provides a ``format_report`` producing byte-identical output to the
corresponding reference C tool (dvbtrate/dvbs2rate/dvbt2rate/atsc3rate).
"""

from dtv_utils_torch.rates import dvbt, dvbs2  # noqa: F401
