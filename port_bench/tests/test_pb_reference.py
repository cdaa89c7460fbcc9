"""The plain reference against the program at a small size on the CPU
(where the program's kernels take their plain twins), and the control:
the reference in bfloat16 must fail the comparison that the program
passes."""

import pytest
import torch

from _small import small
from port_bench import check, program, run

# what the CPU comparison allows, set from CPU readings taken before
# these tests were written (bad_px 0, mean_abs 3.0e-4 on both cells at
# 256x128): rounding of the program's bfloat16 texel and environment
# pools against the reference's float32 maps
CPU_MEAN_ABS = 1e-3
CPU_BAD_PX = 0.002


def _scene(workload, seed, w=256, h=128):
    _w, cfg, mix, mod = run.cell(workload)
    small(cfg, mix, w, h)
    scene = mod.build_scene(cfg, seed)
    return cfg, mix, mod, scene


@pytest.mark.parametrize("workload", ["colonnade-msaa.orbit",
                                      "helmet-ibl.orbit"])
def test_reference_matches_the_program(workload, tmp_path):
    cfg, mix, mod, scene = _scene(workload, 2 ** 32 + 7)
    r = (mod.load_program(scene, "cpu", str(tmp_path))
         if hasattr(mod, "load_program") else program.load(scene, "cpu"))
    drv = run.driver(mix, scene, 2 ** 32 + 7, r, r.render_device)
    shown = [drv.step(i) for i in (0, 9)]
    frames = [drv.shown(i) for i in (0, 9)]
    for img, ref in zip(shown, check.render_reference(frames, "cpu")):
        got = check.compare(img, ref, cfg["check"]["pixel_tol"])
        assert got["bad_px"] <= CPU_BAD_PX, got
        assert got["mean_abs"] <= CPU_MEAN_ABS, got
        # the frame shows geometry and sky both
        assert 0.05 < float(ref[..., 3].mean()) < 0.95


@pytest.mark.parametrize("workload", ["colonnade-msaa.orbit",
                                      "helmet-ibl.orbit"])
def test_bfloat16_control_fails(workload):
    """The control: the reference computed in bfloat16, against itself in
    float32, reads far above what the program reads."""
    cfg, mix, _mod, scene = _scene(workload, 11, 384, 192)
    frame = run.driver(mix, scene, 11).shown(3)
    f32 = next(check.render_reference([frame], "cpu"))
    bf16 = next(check.render_reference([frame], "cpu", torch.bfloat16))
    got = check.compare(bf16, f32, cfg["check"]["pixel_tol"])
    assert got["bad_px"] > 20 * CPU_BAD_PX, got
    assert got["mean_abs"] > 10 * CPU_MEAN_ABS, got
    lim = cfg["check"]["limits"]
    assert any(got[n] > lim[n] for n in lim), (got, lim)
