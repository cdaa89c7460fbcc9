"""device.kernels: CUDA kernels a frame in the profiled frames' trace."""


def read(rec):
    prof = rec["profile"]
    if not prof:
        return None
    return prof["n_kernels"] / prof["frames"]
