"""Device ms a batch of the kernels launched inside the program's ``lm.mla``
spans (each MLA with its input norm, two a double layer: the latent
projections, their norms and scales, RoPE, the causal attention and the o
projection), in the profiled sub-window; a kernel belongs to a span whose
call holds its launch (``span_kernels.py``)."""


def read(r):
    s = (r.w.get("span_device_s") or {}).get("lm.mla")
    units = r.profile.units if r.profile is not None else 0
    return 1e3 * s / units if s and units else None
