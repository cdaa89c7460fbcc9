"""facade.prepare_host_ms: host ms a frame in the RenderTimings span
prepare: between the flush and the frame graph, the prep memo (and its
rerun when the camera moved), the frame's keywords and the retrace
signature."""


def read(rec):
    v = rec["spans_host"].get("prepare")
    return None if v is None else v * 1e3
