"""kernels.roofline_share: the least time the hand-written kernels' roles
could take on the frame's sizes (roofline.py, bytes over the H100's
published 3.35 TB/s), as a share of the device time the profiler gave
the kernels of those roles over the same frames."""

from port_bench import roofline


def read(rec):
    prof = rec["profile"]
    if not prof:
        return None
    spent = sum(t for name, t in prof["device_ops"]
                if roofline.kernel_role(name) is not None)
    if spent <= 0.0:
        return None
    bound = sum(roofline.bound_s(b)
                for b in roofline.role_bytes(rec["sizes"]).values())
    return 100.0 * bound * prof["frames"] / spent
