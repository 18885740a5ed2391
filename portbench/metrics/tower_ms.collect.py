"""Device ms a batch of the kernels launched inside the program's
``omni.tower`` span (the Whisper tower: convs, 32 blocks with attention
kernel #5, the final LayerNorm), in the profiled sub-window; a kernel
belongs to a span whose call holds its launch (``span_kernels.py``)."""


def read(r):
    s = (r.w.get("span_device_s") or {}).get("omni.tower")
    units = r.profile.units if r.profile is not None else 0
    return 1e3 * s / units if s and units else None
