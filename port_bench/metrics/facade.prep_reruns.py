"""facade.prep_reruns: misses of the renderer's prep memo a frame (the
program's counter prepare/rerun, over every timed frame): the memo's key
holds the camera and the stores' mutation counts, so a moving camera or
an edited transform reruns the cull, the buckets and the frame's
specialization."""


def read(rec):
    counts = rec.get("counts")
    return None if counts is None else counts.get("prepare/rerun", 0.0)
