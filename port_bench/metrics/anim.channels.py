"""anim.channels: animation channels sampled a frame (the program's
counter animation/channels, over every timed frame: one update_all a
frame samples every channel of every playing clip). A program without
the counter reads nothing."""


def read(rec):
    counts = rec.get("counts")
    return None if counts is None else counts.get("animation/channels")
