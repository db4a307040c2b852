"""Rate oracles of the port (copies of ``dtv_utils_tpu/rates/``, pure
Python: the reference's package ``__init__`` imports JAX through its
parent, so the modules are copied, not imported)."""
