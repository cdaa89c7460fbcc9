"""anim.update_host_ms: host ms a frame in the RenderTimings span
update_all (the animation players sampled and applied, the transform
graph propagated, the world bounds and the skins' joint matrices
updated). A program without the span reads nothing."""


def read(rec):
    v = rec["spans_host"].get("update_all")
    return None if v is None else v * 1e3
