"""frame.skin_host_ms: host ms a frame in the RenderTimings span
render_frame/vertex/skin inside the vertex stage: the gather of each
corner's influences' joint matrices and their weighted sum. A program
without the span reads nothing."""


def read(rec):
    v = rec["spans_host"].get("render_frame/vertex/skin")
    return None if v is None else v * 1e3
