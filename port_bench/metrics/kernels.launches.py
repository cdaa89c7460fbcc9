"""kernels.launches: launches of the hand-written kernels a frame, the
program's launch_counts differenced over the traced window."""


def read(rec):
    n = rec["frames"]
    return sum(rec["launches"].values()) / n if n else None
