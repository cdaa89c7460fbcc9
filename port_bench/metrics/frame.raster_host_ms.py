"""frame.raster_host_ms: host ms a frame in the RenderTimings span
render_frame/raster inside render_frame/dispatch: the visibility raster
(K1 or K9) and its bins."""


def read(rec):
    v = rec["spans_host"].get("render_frame/raster")
    return None if v is None else v * 1e3
