"""The control, the reference in the nearest precision below the
configuration's put in the program's place, comes out not correct by the
comparison a run makes, while the program's own path passes: at sizes a
test run holds (the cells' widths and steps, short horizons). The
``tf32`` control exists only on the card."""

import pytest

from benchmark import control, run
from benchmark.tests.conftest import cell_names

SEEDS = [2**31 + 31, 2**31 + 32]
CONTROL_SEEDS = [2**31 + 33, 2**31 + 34, 2**31 + 35]


def control_of(cell):
    return run.cell_files(run.ROOT, cell)[3]["check"]["control"]


def assert_separated(readings, limits):
    for reading in readings["program"]:
        assert reading["correct"] is True, reading
        for name, limit in limits.items():
            assert reading[name] <= limit, (name, reading)
    for reading in readings["controls"]:
        assert reading["correct"] is False, reading
        assert any(reading[name] > limit for name, limit in limits.items()), (
            reading
        )


@pytest.mark.parametrize(
    "cell", [c for c in cell_names() if control_of(c) == "bfloat16"]
)
def test_the_bfloat16_control_fails(tiny_root, cell):
    readings = control.readings(
        cell, SEEDS, CONTROL_SEEDS, root=tiny_root, device="cpu"
    )
    limits = run.cell_files(tiny_root, cell)[3]["check"]["limits"]
    assert_separated(readings, limits)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "cell", [c for c in cell_names() if control_of(c) == "tf32"]
)
def test_the_tf32_control_fails(tiny_root, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("TF32 products run on the card only")
    readings = control.readings(cell, SEEDS, CONTROL_SEEDS, root=tiny_root)
    limits = run.cell_files(tiny_root, cell)[3]["check"]["limits"]
    assert_separated(readings, limits)
