"""frame.effects_host_ms: host ms a frame in the RenderTimings span
render_frame/effects inside render_frame/dispatch: bloom, depth of field
and SMAA."""


def read(rec):
    v = rec["spans_host"].get("render_frame/effects")
    return None if v is None else v * 1e3
