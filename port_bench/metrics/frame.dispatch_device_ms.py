"""frame.dispatch_device_ms: device ms a frame between the CUDA events
that bracket the RenderTimings span render_frame/dispatch."""


def read(rec):
    v = rec["spans_device"].get("render_frame/dispatch")
    return None if v is None else v * 1e3
