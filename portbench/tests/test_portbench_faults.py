"""The check catches what it must: a run driven as on the card, with the
timed path broken underneath (faults.py), comes out as not correct, once
for each fault a cell of this benchmark can have; and the control (the
reference in 32-bit integers in the program's place) fails the same
comparison.  (No cell spans chips, so no exchange between chips can be
left out.)"""

import time

import pytest

from portbench import bench, control, faults
from portbench.tests import tiny


@pytest.mark.parametrize("mix", tiny.MIXES)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_broken_timed_path_is_not_correct(fault, mix):
    config, m = tiny.cell(mix)
    with faults.planted(fault):
        w, check, _ = bench.run_cell({"name": mix}, config, m, 2**31 + 99, 0.5, False,
                                     device="cpu", t_start=time.perf_counter(),
                                     log=lambda *a: None)
    assert w.requests > 0
    assert not check.correct, check.numbers
    assert check.numbers["lanes_wrong"][0] > 0


@pytest.mark.parametrize("mix", tiny.MIXES)
def test_control_in_32_bits_is_not_correct(mix):
    _, m = tiny.cell(mix)
    check = control.control_check(m, 2**31 + 5, requests_per_flow=12)
    assert not check.correct
    assert check.numbers["lanes_wrong"][0] > 0 and check.numbers["keys_wrong"][0] > 0
