"""flush.anim_host_ms: host ms a frame in the RenderTimings span
write_gpu/animation inside the flush: the uploads of the stores an
animated frame dirties (world and normal matrices, joint matrices, the
mesh table and morph weights). A program without the span reads
nothing."""


def read(rec):
    v = rec["spans_host"].get("write_gpu/animation")
    return None if v is None else v * 1e3
