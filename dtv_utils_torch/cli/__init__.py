"""``dtv`` command-line interface of the port.

Usage: ``python -m dtv_utils_torch.cli <tool> [args...]``, with the same
16 subcommands as ``dtv_utils_tpu.cli``: the modulators (``dvbt-mod``,
``dvbt2-mod``, ``qam-mod``), the receivers (``dvbt-rx``, ``dvbt2-rx``,
``qam-rx``), ``papr`` and ``profile``, which take ``--device cuda|cpu``
(default ``cuda``); the rate oracles (``dvbtrate``, ``dvbs2rate``,
``dvbt2rate``, ``atsc3rate``) and the native analyzers (``xport``,
``flags264``, ``h264_parse``, ``l1dump``), which run on the host.
"""
