"""AUs per DAB+ step whose content the CUDA kernel packed: the `aus` counted
on the program's dabplus.aupack.kernel span (one per kernel launch).  A
program without the kernel keeps no such span, and the metric is left out."""
from benchmark import spans


def read(run):
    return spans.count_per_step(spans.recorded(run), "dabplus.aupack.kernel", "aus")
