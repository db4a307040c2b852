"""Receivers that invert the ``tx/`` modulators: IQ in, transport stream
out (port of ``dtv_utils_tpu/rx``): DVB-T (``rx/dvbt.py``), DVB-T2
(``rx/dvbt2.py``) and J.83B (``rx/j83b.py``)."""
