"""The program's own host spans (`odr_audioenc_tpu_torch.obs`), as the
per-layer readers take them.  The program records spans while a torch
profiler records: in a `--trace 1` run, over the two traced slices after
the window.  Every figure is per step, a step being one top-level `*.step`
span; times are host ms under the profiler, which slows the host, so they
compare one commit with another and not with `dispatch_ms`."""


def recorded(run):
    """The spans the program kept since the run's window ended; None for a
    run with no traced slice, or where the program keeps none (it has no
    `obs` module)."""
    if run.get("trace") is None:
        return None
    try:
        from odr_audioenc_tpu_torch import obs
    except ImportError:
        return None
    after = run["window"][1] * 1e9          # the window's host clock is perf_counter
    return [s for s in obs.spans() if s.start_ns >= after]


def steps(spans):
    return sum(1 for s in spans if s.parent is None and s.name.endswith(".step"))


def _inside(span, match):
    p = span.parent
    while p is not None:
        if match(p.name):
            return True
        p = p.parent
    return False


def ms_per_step(spans, match):
    """Host ms per step in the spans whose name `match` takes (none of them
    nesting another), less the `*.sync` spans inside them: the host's own
    time there, without its waits for the device.  None without steps or
    without such spans."""
    if not spans or not steps(spans):
        return None
    hit = [s for s in spans if match(s.name)]
    if not hit:
        return None
    waits = [s for s in spans if s.name.endswith(".sync") and _inside(s, match)]
    ns = sum(s.end_ns - s.start_ns for s in hit) - sum(s.end_ns - s.start_ns for s in waits)
    return ns / 1e6 / steps(spans)


def count_per_step(spans, name, key):
    """The count `key` summed over the spans `name`, per step; None without
    steps or without such spans."""
    if not spans or not steps(spans):
        return None
    hit = [s for s in spans if s.name == name]
    if not hit:
        return None
    return sum(s.counts.get(key, 0) for s in hit) / steps(spans)
