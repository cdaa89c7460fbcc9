"""anim.joints: joint matrices recomputed a frame (the program's counter
skins/joints, over every timed frame: every joint of each skin whose
joints moved). A program without the counter reads nothing."""


def read(rec):
    counts = rec.get("counts")
    return None if counts is None else counts.get("skins/joints")
