"""A whole run of each cell on the CPU, past the harness's look for a
card, with the timed path sound and then broken underneath (faults.py):
`correct` has to come out true, and false for each fault a frame can
have, for the control (the reference in bfloat16) in the program's
place, and for the layer the colonnade's panes are drawn by left out."""

import pytest

from _small import small
from port_bench import faults, run

# window seconds that finish the two checked frames on the CPU, where
# the colonnade's MSAA raster takes its plain twin
CELLS = {"colonnade-msaa.orbit": 8.0, "helmet-ibl.orbit": 2.0}


def _run(workload, wrap):
    return run.run_cell(workload, 2 ** 31 + 99, CELLS[workload], False,
                        device="cpu",
                        edit_cfg=lambda c, m: small(c, m, 128, 64),
                        wrap=wrap, log=lambda msg: None)


@pytest.mark.parametrize("workload", list(CELLS))
def test_sound_run_is_correct(workload):
    res = _run(workload, None)
    assert res["correct"], res["check"]
    assert res["failed"] == 0
    assert list(res)[-1] == "check"
    for n, v in res["check"].items():
        assert v["value"] <= v["limit"], (n, v)


@pytest.mark.parametrize("fault", ["stale", "altered", "half",
                                   "control_bf16"])
@pytest.mark.parametrize("workload", list(CELLS))
def test_a_fault_is_not_correct(workload, fault):
    res = _run(workload, faults.WRAPS[fault])
    assert not res["correct"], res["check"]
    assert res["failed"] >= 1


def test_dropped_panes_are_not_correct():
    res = _run("colonnade-msaa.orbit", faults.panes_dropped)
    assert not res["correct"], res["check"]
