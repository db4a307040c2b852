"""``dtv`` command-line interface of the port.

Usage: ``python -m dtv_utils_torch.cli <tool> [args...]``.  So far only
``qam-mod`` is ported; the other subcommands remain in ``dtv_utils_tpu.cli``.
"""
