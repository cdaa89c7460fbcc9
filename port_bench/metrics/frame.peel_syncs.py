"""frame.peel_syncs: host checks of the transparent peel a frame (the
program's counter render_frame/peel_sync, over every timed frame): each
one waits on the device to learn whether the deeper peels hold a
fragment."""


def read(rec):
    counts = rec.get("counts")
    return None if counts is None else counts.get("render_frame/peel_sync",
                                                  0.0)
