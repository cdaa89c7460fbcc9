"""frame.display_host_ms: host ms a frame in the RenderTimings span
render_frame/display inside render_frame/dispatch: the crop, the display
pass, the stack and the pick-id remap."""


def read(rec):
    v = rec["spans_host"].get("render_frame/display")
    return None if v is None else v * 1e3
