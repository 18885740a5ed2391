"""Device ms a batch of the kernels launched inside the program's
``lm.dense`` spans (each dense SwiGLU FFN with its norm, two a double layer;
the first norm's output is also the MoE's input), in the profiled
sub-window (``span_kernels.py``)."""


def read(r):
    s = (r.w.get("span_device_s") or {}).get("lm.dense")
    units = r.profile.units if r.profile is not None else 0
    return 1e3 * s / units if s and units else None
