"""Host ms per DAB+ step in the SBR analysis: the program's dabplus.sbr
span (the QMF analysis, the envelope and noise side data, the FIL bit
count and the half-band decimator).  A program without SBR keeps no such
span, and the metric is left out."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(spans.recorded(run), lambda n: n == "dabplus.sbr")
