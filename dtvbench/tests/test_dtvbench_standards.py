"""What a receive standard's module gives ``drivers/stream_rx.py``: the
work of a call (``rx_work``, read by ``viterbi_roofline.rx``) and the
readings logged beside the check (``rx_info``), for DVB-T and J.83B the
values that the driver computed itself before the standards gave them.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from dtvbench.standards import dvbt, j83b


@pytest.mark.parametrize("std,blocks,want", [
    (dvbt, 1, (8636544, 7, 9870336)),
    (dvbt, 2, (17273088, 7, 19740672)),
    (j83b, 1, (2889936, 5, 3612420)),
    (j83b, 2, (5779872, 5, 7224840)),
], ids=["dvbt-1", "dvbt-2", "j83b-1", "j83b-2"])
def test_rx_work_is_the_viterbi_trellis(std, blocks, want):
    assert std.viterbi_work(blocks) == want
    assert std.rx_work(blocks) == {"viterbi": want}


@pytest.mark.parametrize("std", [dvbt, j83b], ids=["dvbt", "j83b"])
def test_rx_info_is_the_rs_corrections_per_call(std):
    results = [SimpleNamespace(rs_errors=np.array([0, 3, 1], np.int32)),
               SimpleNamespace(rs_errors=np.array([2, 0, 0], np.int32)),
               SimpleNamespace(rs_errors=np.zeros(3, np.int32))]
    assert std.rx_info(results) == {"rs_corrected_per_call": 2.0}
