"""The 95th percentile, over the window's steps, of the time from handing a
step's audio to the program to the end of that step's drain (ms)."""
import statistics


def read(run):
    delays = [1000.0 * (s["done"] - s["hand"]) for s in run["steps"]]
    if len(delays) < 20:
        return None
    return statistics.quantiles(delays, n=20, method="inclusive")[18]
