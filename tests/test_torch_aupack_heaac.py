"""The HE-AAC and HE-AAC v2 half of tests/test_torch_aupack_e2e.py's
comparison: on the port's f32 outputs of four signals in a row, the port's
device pack, its host writer and the JAX package's aupack.pack_from_outputs
give the same bytes.  A file of its own, so that the suite's workers share
the halves' time: the JAX pack runs eagerly, ~15-60 s per case."""
import pytest

import test_torch_aupack_e2e as E2E
from torch_cpu import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", E2E.CASES[4:], ids=E2E.case_id)
def test_device_pack_matches_host_and_jax_heaac(case):
    E2E.run_pack_case(case, False)
