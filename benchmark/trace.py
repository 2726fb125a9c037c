"""The traced slice: `steps` more rounds of the pipeline right after the
window, under torch.profiler, reduced to the numbers the per-layer readers
take (the method of the port's profile_dabplus.py: device events are the
CUDA kernels, memcpys and memsets, not the device-side ranges of the
harness's own host spans; busy time is here the union of their intervals,
so that overlapping copies are not counted twice).  Before it, a slice
of the device alone gives the device's busy and wall time of the same
rounds, both from the trace."""

TOP = 10


def profile_rounds(pipe, steps):
    """Run `steps` pipeline rounds under the profiler; returns the raw
    events: (device [(name, start_us, end_us)], host [(name, start_us,
    end_us)], the slice's start and end in trace microseconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    span = pipe.span
    pipe.span = record_function
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench.slice"):
                for _ in range(steps):
                    pipe.round()
                torch.cuda.synchronize()
    finally:
        pipe.span = span
    device, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        (device if e.device_type == DeviceType.CUDA else host).append(item)
    s = [h for h in host if h[0] == "bench.slice"][0]
    return {"device": device, "host": host, "start_us": s[1], "end_us": s[2], "steps": steps}


def device_rounds(pipe, steps, device):
    """Run `steps` pipeline rounds under the profiler with the device's
    activity alone (no host ops are recorded, so the host issues its
    launches at about its own pace), on an idle device and between two
    one-element fills: {"steps", "busy_s", "window_s"}, the union of the
    device's activity and the time from the first fill's start to the last
    one's end, both on the device's clock; None if the trace holds no
    device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mark = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mark.fill_(1.0)
        for _ in range(steps):
            pipe.round()
        mark.fill_(2.0)
        torch.cuda.synchronize(device)
    return busy_and_wall([(float(e.time_range.start), float(e.time_range.end))
                          for e in prof.events() if e.device_type == DeviceType.CUDA], steps)


def busy_and_wall(spans, steps):
    """The device-only slice's figures from its device spans (us), the two
    fills among them; None without spans."""
    if not spans:
        return None
    t0, t1 = min(a for a, _ in spans), max(b for _, b in spans)
    return {"steps": steps, "busy_s": sum(b - a for a, b in union(spans)) * 1e-6,
            "window_s": (t1 - t0) * 1e-6}


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _open_at(times, host):
    """For each of the sorted `times`, the host events under way then,
    outermost first (host calls of one thread nest, so a stack holds them)."""
    events = sorted(host, key=lambda h: (h[1], -h[2]))
    stack, j, out = [], 0, []
    for t in times:
        while j < len(events) and events[j][1] <= t:
            while stack and stack[-1][2] < events[j][1]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(list(stack))
    return out


def summarize(raw):
    """The slice's figures: busy and wall seconds, device events and host
    syncs, device time and calls by name, and the idle gaps labelled by the
    harness phase and the innermost host call under way at their middle."""
    t0, t1 = raw["start_us"], raw["end_us"]
    # the profiler mirrors each host span (record_function) on the device's
    # timeline: those ranges are not device work
    dev = [(n, max(a, t0), min(b, t1)) for n, a, b in raw["device"]
           if b > t0 and a < t1 and not n.startswith("bench.")]
    busy = union([(a, b) for _, a, b in dev])
    by_name = {}
    for n, a, b in dev:
        calls, us = by_name.get(n, (0, 0.0))
        by_name[n] = (calls + 1, us + (b - a))
    gaps, last = [], t0
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = b
    if t1 > last:
        gaps.append((last, t1))
    idle = {}
    for (a, b), stack in zip(gaps, _open_at([0.5 * (a + b) for a, b in gaps], raw["host"])):
        phase = [h for h in stack if h[0].startswith("bench.") and h[0] != "bench.slice"]
        inner = stack[-1] if stack else None
        label = (phase[-1][0] if phase else "between phases") + \
            (f" / {inner[0]}" if inner is not None and not inner[0].startswith("bench.") else "")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return {
        "steps": raw["steps"],
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_events": len(dev),
        "host_syncs": sum(1 for h in raw["host"] if h[0] == "aten::_local_scalar_dense"),
        "device_by_name": {n: {"calls": c, "s": us * 1e-6} for n, (c, us) in by_name.items()},
        "idle_by_host": idle,
    }


def breakdown(summary):
    """The result line's `breakdown`: the device operations that took most
    time, and the idle time by what the host was doing, [name, seconds]."""
    ops = sorted(summary["device_by_name"].items(), key=lambda kv: -kv[1]["s"])[:TOP]
    gaps = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:160], v["s"]] for n, v in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}


