"""frame.shade_host_ms: host ms a frame in the RenderTimings span
render_frame/shade inside render_frame/dispatch: the resolve (K2) and
the deferred shade."""


def read(rec):
    v = rec["spans_host"].get("render_frame/shade")
    return None if v is None else v * 1e3
