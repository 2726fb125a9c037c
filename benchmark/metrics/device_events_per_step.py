"""Device events (kernels, memcpys, memsets) per step in the traced slice."""


def read(run):
    t = run["trace"]
    return None if t is None or not t["device_events"] else t["device_events"] / t["steps"]
