"""Host ms per step that the program waited for the device at its own syncs:
every *.sync span (the allocator tail's tests, the rate loop's recovery
check)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(spans.recorded(run), lambda n: n.endswith(".sync"))
