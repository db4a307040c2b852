"""Host-to-device and device-to-host copy time per served call, in ms:
the durations of the profiler's memcpy activities whose name says HtoD or
DtoH, over the traced calls.  Copies inside the device (a graph's
copy-in and copy-out of its static buffers) are not counted."""

from dtvbench.layer_metrics._device import per_call

HOST_COPIES = ("HtoD", "DtoH")


def value(run):
    s = run.summary
    if s is None:
        return None
    ms = sum(e["dur"] for e in s.acts if e.get("cat") == "gpu_memcpy"
             and any(k in e["name"] for k in HOST_COPIES)) / 1e3
    return per_call(run, ms)
