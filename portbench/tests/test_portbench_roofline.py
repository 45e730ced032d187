"""roofline.py's counts against hand counts, one tiny case per kind of cell."""

import pytest

from portbench import roofline


def test_forward_call_bytes_and_operations():
    # 2 molecules of 3 typed atoms, 2 channels of 4^3 voxels each, float32 grids
    w = roofline.forward(atoms=6, weights=6, molecules=2, out_elements=2 * 2 * 64, out_itemsize=4)
    assert w.bytes == 6 * 12 + 6 * 4 + 2 * 40 + 2 * 2 * 64 * 4  # 1200
    assert w.pair_ops == 6 * 13 + 6 * 2  # 90 operations per pair per atom


def test_bf16_batch_is_half_the_grid_bytes():
    w32 = roofline.forward(atoms=10, weights=10, molecules=1, out_elements=4 * 8**3, out_itemsize=4)
    w16 = roofline.forward(atoms=10, weights=10, molecules=1, out_elements=4 * 8**3, out_itemsize=2)
    assert w32.bytes - w16.bytes == 4 * 8**3 * 2


def test_batch_of_molecules_adds_their_atoms_and_headers():
    one = roofline.forward(atoms=5, weights=5, molecules=1, out_elements=64, out_itemsize=4)
    two = roofline.forward(atoms=10, weights=10, molecules=2, out_elements=128, out_itemsize=4)
    assert two.bytes == 2 * one.bytes and two.pair_ops == 2 * one.pair_ops
    assert (one + one).bytes == two.bytes


def test_least_time_takes_the_larger_bound():
    w = roofline.Work(bytes=3.35e12, pair_ops=67e12)  # 1 s of bytes; operations = pairs per atom seconds
    assert roofline.least_seconds(w, 0.5) == (pytest.approx(1.0), "bytes")
    assert roofline.least_seconds(w, 2.0) == (pytest.approx(2.0), "operations")
    assert (w * 3).bytes == 3 * w.bytes
