"""facade.host_ms: host ms a frame from the frame's start until
render_device() returns, before the synchronize (benchmark clock): the
facade's prep, flush and the frame graph's dispatch, as the host pays
them."""


def read(rec):
    xs = rec["host_render_s"]
    return sum(xs) * 1e3 / len(xs) if xs else None
