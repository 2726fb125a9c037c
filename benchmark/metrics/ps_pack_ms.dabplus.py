"""Host ms per DAB+ step in the PS extension's slot groups of the FIL
element for the device pack: the program's dabplus.sbr.pack.ps span (one
per superframe, inside dabplus.sbr.pack).  A program that does not span
them keeps the build unspanned, and the metric is left out."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(spans.recorded(run), lambda n: n == "dabplus.sbr.pack.ps")
