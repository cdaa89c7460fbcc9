"""facade.syncs: host waits on the device a frame (torch's sync debug
mode over consecutive moving-camera frames, their mean)."""


def read(rec):
    xs = rec["syncs"]
    return sum(xs) / len(xs) if xs else None
