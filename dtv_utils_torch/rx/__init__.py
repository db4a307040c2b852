"""Receivers that invert the ``tx/`` modulators: IQ in, transport stream
out (port of ``dtv_utils_tpu/rx``).  So far DVB-T (``rx/dvbt.py``) and
J.83B (``rx/j83b.py``); the DVB-T2 receiver is not ported yet."""
