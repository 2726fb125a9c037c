"""Host ms per MP2 step in the psy model: the program's mp2.psy span."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(spans.recorded(run), lambda n: n == "mp2.psy")
