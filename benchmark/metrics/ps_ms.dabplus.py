"""Host ms per DAB+ step in the HE-AAC v2 parametric-stereo stage: the
program's dabplus.ps span (the IID/ICC band analysis with its
stabilisation, and the energy-compensated mono downmix).  A program
without PS, or without spans, keeps no such span, and the metric is left
out."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(spans.recorded(run), lambda n: n == "dabplus.ps")
