"""Share of its roofline, in %, of the Viterbi decoding of the traced
receive calls: the least time of each call's trellis (``roofline.py``,
from the problem's shapes and the data sheet's peaks) over the device
time of the kernels launched inside the program's ``viterbi_acs`` and
``viterbi_traceback`` ranges."""

from dtvbench import roofline


def value(run):
    s = run.summary
    if s is None:
        return None
    acts = [e for e in s.in_ranges(("viterbi_acs", "viterbi_traceback"))
            if e.get("cat") == "kernel"]
    if not acts:
        return None
    device_s = sum(e["dur"] for e in acts) / 1e6
    steps, k, llrs = run.outcome.work["viterbi"]
    least = roofline.viterbi_least_s(steps, k, llrs, run.kind) * s.calls
    return 100.0 * least / device_s
