"""frame.resolve_host_ms: host ms a frame in the RenderTimings span
render_frame/resolve inside render_frame/dispatch: the MSAA edge blend
or the supersample resolve."""


def read(rec):
    v = rec["spans_host"].get("render_frame/resolve")
    return None if v is None else v * 1e3
