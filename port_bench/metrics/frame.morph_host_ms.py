"""frame.morph_host_ms: host ms a frame in the RenderTimings span
render_frame/vertex/morph inside the vertex stage: the gather of every
target's deltas and the weighted sum over the animated triangles. A
program without the span reads nothing."""


def read(rec):
    v = rec["spans_host"].get("render_frame/vertex/morph")
    return None if v is None else v * 1e3
