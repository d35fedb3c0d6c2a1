"""The control comes out not correct: the plain reference put in the
program's place at float32 with TF32 matrix products fails one of each
cell's numbers.  Needs the card (TF32 exists only there):

    python -m pytest gpbench/tests/test_gpbench_control.py -m cuda
"""

import pytest
import torch

from gpbench import control


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["multi_b1024", "single_b1024", "multi_calls128"])
def test_the_control_fails_a_number(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products need a CUDA device")
    out = control.control_numbers(cell, 2147480001, device="cuda", pool_size=256)
    assert out["fails"], out["numbers"]
