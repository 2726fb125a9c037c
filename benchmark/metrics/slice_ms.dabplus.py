"""Host milliseconds of DabPlusEncoder.pack_superframes per step (slicing
each station's superframe from the device-packed rows), averaged over the
window's steps."""


def read(run):
    if run["codec"] != "dabplus":
        return None
    return 1000.0 * sum(s["drain_s"] for s in run["steps"]) / len(run["steps"])
