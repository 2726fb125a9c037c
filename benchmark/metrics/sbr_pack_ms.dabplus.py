"""Host ms per DAB+ step in the SBR FIL element's slot groups for the
device pack: the program's dabplus.sbr.pack span (one per superframe).  A
program without that span keeps the build unspanned, and the metric is
left out."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(spans.recorded(run), lambda n: n == "dabplus.sbr.pack")
