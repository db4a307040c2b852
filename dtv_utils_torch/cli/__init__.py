"""``dtv`` command-line interface of the port.

Usage: ``python -m dtv_utils_torch.cli <tool> [args...]``.  Ported so far:
``dvbt-mod``, ``dvbt2-mod``, ``qam-mod``, ``dvbt-rx``, ``dvbt2-rx``,
``qam-rx``, ``papr`` and ``dvbt2rate``; the other subcommands remain in
``dtv_utils_tpu.cli``.
"""
