"""Host milliseconds of the dabplus step's dispatch (the driver's call into the
encoder, with every host sync inside it), averaged over the window's steps."""


def read(run):
    if run["codec"] != "dabplus":
        return None
    return 1000.0 * sum(s["dispatch_s"] for s in run["steps"]) / len(run["steps"])
