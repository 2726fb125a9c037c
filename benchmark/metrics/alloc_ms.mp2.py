"""Host ms per MP2 step in the bit allocation: the program's mp2.alloc span
(scfsi, js_mode_select, the greedy and its tail), less the tail's syncs
(mp2.tail.sync)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(spans.recorded(run), lambda n: n == "mp2.alloc")
