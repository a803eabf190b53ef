"""On the card: the output check's control. The reference put in the
program's place and computed one precision step down (float32 with TF32
on, where the program runs float32 with TF32 off) must fail the check,
while the program passes it, at a size a test run holds: 256 sequences
(as many rows as the cell samples), a whole job. Run on the card from
the root of a checkout:

    python -m pytest -p no:cacheprovider portbench/tests/test_pb_card.py
"""
import pytest

from portbench import harness
from portbench.control import readings


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["pcw_sqrt.montecarlo"])
def test_control_fails_the_check_the_program_passes(card, workload):
    limits = harness.cell_files(workload)[2]["check"]["limits"]
    r = readings(workload, 2 ** 31 + 5, True, batch=256)
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r
