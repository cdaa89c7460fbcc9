"""facade.render_host_ms: host ms a frame in the RenderTimings span
render_device, the whole of the facade's render_device() call (the
program's own clock, beside facade.host_ms on the benchmark's)."""


def read(rec):
    v = rec["spans_host"].get("render_device")
    return None if v is None else v * 1e3
