"""device.idle_share: the share of the profiled frames' window in which
no operation ran on the device (1 - the union of kernel, copy and set
intervals over the window). The profiler slows the host, so it reads
high."""


def read(rec):
    prof = rec["profile"]
    if not prof or prof["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
