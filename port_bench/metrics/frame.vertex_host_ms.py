"""frame.vertex_host_ms: host ms a frame in the RenderTimings span
render_frame/vertex inside render_frame/dispatch: the vertex stage and
its setup rows."""


def read(rec):
    v = rec["spans_host"].get("render_frame/vertex")
    return None if v is None else v * 1e3
