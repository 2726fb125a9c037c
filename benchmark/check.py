"""Whether what the timed path emitted is correct.

A sample of the window's answers, drawn from the seed (the workload's
`check`: a fixed set of `stations`, one from each of as many equal blocks
of the batch, whose every step is kept, or `per_step` stations drawn
afresh at each step), is kept as the drains
emit it.  Once the window has closed and the program is freed, the
configuration's plain reference (reference/<name>.py) encodes the same
stations from the same audio.  Two numbers are compared, each held to the
workload's limit for it: `<unit>_differ_pct`, the share of kept answers
whose bytes differ from the reference's, and `<unit>_invalid_pct`, the
share that fail their own integrity checks (CRCs, RS), which the
configuration guarantees in every answer.
"""
import numpy as np

from benchmark import registry
from benchmark.traffic.programme import SEED_MASK


def keep_rule(chk, S, seed):
    """k -> the stations whose bytes of step k are kept."""
    if "stations" in chk:
        # one station from each of `stations` equal blocks of the batch, so
        # that a fault confined to some slots of it meets the sample
        rng = np.random.default_rng([int(seed) & SEED_MASK, 2])
        rows = [int(b[rng.integers(len(b))])
                for b in np.array_split(np.arange(S), min(S, chk["stations"]))]
        return lambda k: rows
    m = min(S, chk["per_step"])
    return lambda k: sorted(np.random.default_rng([int(seed) & SEED_MASK, 3, k])
                            .choice(S, m, replace=False).tolist())


def compare(config, workload, prog, kept, device, root=registry.ROOT):
    """(checks, compared, failed): each compared number with its limit, the
    answers compared, and those missing or of the wrong length."""
    import torch
    ref = registry.module("reference", config["reference"], root)
    keys = sorted(kept)
    want = ref.expected(config, workload, prog, keys, device, torch.float64)
    n = max(1, len(keys))
    values = {f"{ref.UNIT}_differ_pct": 100.0 * sum(kept[k] != want[k] for k in keys) / n,
              f"{ref.UNIT}_invalid_pct": 100.0 * sum(not ref.valid(kept[k]) for k in keys) / n}
    limits = workload["check"]["limits"]
    failed = sum(len(kept[k]) != len(want[k]) for k in keys)
    return ({name: {"value": v, "limit": limits[name]} for name, v in values.items()},
            len(keys), failed)
