"""The copied roofline arithmetic gives the bounds the records hold."""

import pytest

from benchmark import roofline


def test_k1_flagship_bound_is_21_064_us_by_bytes():
    bound_ms, by = roofline.stencil_bound(
        "diffusion", 1, 40_000, 21 * 21, 1, trajectory=True
    )
    assert by == "bytes"
    assert bound_ms * 1e3 == pytest.approx(21.064, abs=5e-4)


def test_navier_stokes_example_bound_is_81_742_us_by_operations():
    bound_ms, by = roofline.navier_stokes_bound(
        101 * 81, 1, 2_000, 33_163, trajectory=True
    )
    assert by == "operations"
    assert bound_ms * 1e3 == pytest.approx(81.742, abs=5e-4)


def test_bound_takes_the_larger_side():
    assert roofline.bound(3.35e12, 1.0) == (1e3, "bytes")
    assert roofline.bound(1.0, 67e12) == (1e3, "operations")
