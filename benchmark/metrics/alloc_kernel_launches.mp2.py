"""Launches per MP2 step of the bit-allocation kernel: the `launches`
counted on the program's mp2.alloc.kernel span (one per kernel launch).
A program without the kernel keeps no such span, and the metric is left out."""
from benchmark import spans


def read(run):
    return spans.count_per_step(spans.recorded(run), "mp2.alloc.kernel", "launches")
