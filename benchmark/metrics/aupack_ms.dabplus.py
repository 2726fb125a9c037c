"""Host ms per DAB+ step in the device pack: the program's dabplus.aupack
spans (each AU's slot groups and content pack) and dabplus.assemble (the
superframe, its CRCs and RS, and the wire leaf)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(spans.recorded(run),
                             lambda n: n in ("dabplus.aupack", "dabplus.assemble"))
