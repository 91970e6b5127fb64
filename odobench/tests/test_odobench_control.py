"""The check's control on the card: the plain reference computed with TF32
matrix products in the program's place fails the check that sound runs
pass (the control is run at the cells' own sizes on the chip by
`control.py`; here at full width on 80-scan drives). Cards only: TF32
exists only on the card."""

import pytest
import torch

import _paths  # noqa: F401


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vlp16.replay", "vlp16.fleet8"])
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32)")
    import control
    import harness

    cell = harness.load_cell(name, overrides={"traffic": {"scans_per_drive": 80}})
    out = control.readings(cell, 2024, torch.device("cuda", 0))
    assert out["correct"] is False, out
