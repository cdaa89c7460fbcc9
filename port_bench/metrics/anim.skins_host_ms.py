"""anim.skins_host_ms: host ms a frame in the RenderTimings span
update_all/skins (the joint matrices of the skins whose joints moved).
A program without the span reads nothing."""


def read(rec):
    v = rec["spans_host"].get("update_all/skins")
    return None if v is None else v * 1e3
