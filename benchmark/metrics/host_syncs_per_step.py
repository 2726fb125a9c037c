"""Host syncs per step in the traced slice: the profiler's count of
aten::_local_scalar_dense (the allocator tail's and the recovery check's
reads of a device value)."""


def read(run):
    t = run["trace"]
    return None if t is None else t["host_syncs"] / t["steps"]
