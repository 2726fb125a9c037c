"""Passes per MP2 step of the allocator tail's loop: the `passes` counted on
the program's mp2.alloc.tail span, one host sync each."""
from benchmark import spans


def read(run):
    return spans.count_per_step(spans.recorded(run), "mp2.alloc.tail", "passes")
