"""frame.dispatch_host_ms: host ms a frame in the RenderTimings span
render_frame/dispatch (the frame graph enqueuing its work)."""


def read(rec):
    v = rec["spans_host"].get("render_frame/dispatch")
    return None if v is None else v * 1e3
