"""On a CUDA card, at the cells' own sizes: a short run of each cell is
correct, and a run with the control (the reference in bfloat16) in the
program's place is not. Skipped on a host without a card:
    python -m pytest port_bench/tests/test_pb_card.py -q"""

import json
import subprocess
import sys

import pytest

from port_bench import run

CELLS = ["colonnade-msaa.orbit", "helmet-ibl.orbit",
         "colonnade-msaa-editor.edit"]
# the control's window: long enough to finish the checked frames, each
# of them the reference rendered in bfloat16 (the edit cell builds it
# anew for every frame: its scene moves)
CONTROL_S = {"colonnade-msaa-editor.edit": 14.0}


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(workload):
    _card()
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", workload,
         "--seed", str(2 ** 33 + 17), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_full_size(workload):
    """The control in the program's place, through a whole run of the
    cell: the harness's own verdict says not correct."""
    _card()
    from port_bench import control

    got = control.readings(workload, 2 ** 32 + 3, "control_bf16",
                           CONTROL_S.get(workload, 3.0))
    assert not got["correct"], got
