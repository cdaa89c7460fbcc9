"""Small CPU versions of the cells for the tests."""

import torch

# a few threads: the tests run beside others
torch.set_num_threads(min(4, torch.get_num_threads()))


def small(cfg, mix, width=256, height=128):
    """Shrink a configuration and its mix to a CPU test's size: the same
    code paths (MSAA, panes, effects, five maps), far fewer pixels,
    triangles and texels, and a window of a few frames."""
    cfg["render"].update(width=width, height=height)
    if "grid" in cfg:
        # a 3 x 3 colonnade inside the ring of panes, the camera closer
        cfg["grid"] = 1
        cfg["camera"].update(radius=6.0, height=3.0)
    else:
        cfg.update(map_size=128, lat=24, lon=24)
    cfg["check"]["frames"] = 2
    mix["warmup_views"] = 2
