"""A run drives the timed path and its check end to end (on the CPU, at a
tiny size, without the look for a card): a sound run comes out correct,
and each fault planted under the timed path comes out not correct."""
import pytest

from benchmark.faults import FAULTS
from tiny import run_tiny, tiny_copy

CELLS = {"mp2_48k.mux_mix": 1.5, "dabplus_lc96.music": 2.0}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell):
    line = run_tiny(root, cell, seconds=CELLS[cell])
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["compared"] >= 8
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(root, cell, fault):
    line = run_tiny(root, cell, seconds=CELLS[cell], wrap=FAULTS[fault])
    assert not line["correct"], (fault, line["checks"])
