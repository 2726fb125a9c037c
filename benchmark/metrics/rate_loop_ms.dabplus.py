"""Host ms per DAB+ step in the rate loop: the program's dabplus.rate.*
spans (the 6 + 5 bisect counts, the final DP count, the afterburner
rounds, crash recovery's recount where it runs), less its syncs inside
them."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(spans.recorded(run), lambda n: n.startswith("dabplus.rate."))
