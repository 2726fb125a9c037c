"""Host milliseconds of Mp2Packer.emit per step (the ScF-CRC patch and the
per-station slicing), averaged over the window's steps."""


def read(run):
    if run["codec"] != "mp2":
        return None
    return 1000.0 * sum(s["drain_s"] for s in run["steps"]) / len(run["steps"])
