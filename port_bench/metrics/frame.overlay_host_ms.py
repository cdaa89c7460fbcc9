"""frame.overlay_host_ms: host ms a frame in the RenderTimings span
render_frame/overlay inside render_frame/dispatch: the transparent peel
and the HUD, with their own vertex, raster and shade."""


def read(rec):
    v = rec["spans_host"].get("render_frame/overlay")
    return None if v is None else v * 1e3
