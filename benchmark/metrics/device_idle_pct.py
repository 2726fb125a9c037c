"""The device's idle share (%): 100 x (1 - busy / wall) of the slice of
rounds traced with the device's activity alone, both taken from the trace
on the device's clock: busy the union of its kernels, copies and memsets,
wall from a fill on the idle device before the rounds to one after them."""


def read(run):
    t = run["trace"]
    d = t and t.get("device")
    if not d or not d["busy_s"] or not d["window_s"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
