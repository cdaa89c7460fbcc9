"""flush.host_ms: host ms a frame in the RenderTimings span write_gpu
(the facade's _flush of the dirty stores)."""


def read(rec):
    v = rec["spans_host"].get("write_gpu")
    return None if v is None else v * 1e3
