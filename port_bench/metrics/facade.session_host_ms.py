"""facade.session_host_ms: host ms a frame of the driver's step outside
the renderer's render_device() call (benchmark clock, less the program's
render_device span): in an editing session the event routing, the
pick's wait on the device, the drag's ray math and the transform edits'
update_all."""


def read(rec):
    xs = rec["host_render_s"]
    rd = rec["spans_host"].get("render_device")
    if not xs or rd is None:
        return None
    return (sum(xs) / len(xs) - rd) * 1e3
