"""One run of one cell: set-up, the window, the traced slice, and the check."""
import gc
import time

from benchmark import check, registry
from benchmark.trace import device_rounds, profile_rounds, summarize
from benchmark.traffic.programme import Programme
from benchmark.window import Pipeline, run_window


def run_cell(cell, seed, seconds, trace, device, t_start, root=registry.ROOT,
             make_driver=None, wrap=None, per_step=None):
    """Returns (run, checks, compared, failed, memory_peak_bytes).  `run` is
    what the metric readers take: the cell's settings, `setup_s`, the
    window's start and end, every window step's host times, the program's
    counters over the window and, with `trace`, the traced slice's summary
    with, under `device`, the device-only slice's busy and wall time.
    make_driver replaces the configuration's driver (the control); wrap
    breaks the driver (the fault tests); per_step replaces the check's
    stations drawn per step (the control's fewer, slower steps)."""
    import torch
    from odr_audioenc_tpu_torch.fleet import _Transfers

    wl, cfg = registry.cell(cell, root)
    if per_step is not None:
        wl["check"]["per_step"] = per_step
    make = registry.module("traffic", wl["programme"]["kind"], root).make
    prog = Programme(wl, cfg["channels"], cfg["samples_per_step"], seed, make,
                     cfg["sample_rate"])
    driver = (make_driver or registry.module("drivers", cfg["driver"], root).Driver)(
        cfg, wl, device)
    if wrap is not None:
        driver = wrap(driver)
    counters = getattr(driver, "counters", dict)
    pipe = Pipeline(driver, prog, _Transfers(device), check.keep_rule(wl["check"],
                                                                      wl["stations"], seed))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = counters()
    t0, t1, ks = run_window(pipe, seconds)
    after = counters()
    traced = None
    if trace:
        alone = device_rounds(pipe, wl["trace_steps"], device) if cuda else None
        traced = dict(summarize(profile_rounds(pipe, wl["trace_steps"])), device=alone)
    pipe.finish()
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = {"cell": cell, "codec": cfg["codec"], "S": wl["stations"], "chips": wl["chips"],
           "audio_s": cfg["samples_per_step"] / cfg["sample_rate"],
           "setup_s": t0 - t_start, "window": (t0, t1),
           "steps": [pipe.steps[k] for k in ks], "trace": traced,
           "counters": {k: after[k] - before[k] for k in after}}
    window = set(ks)
    kept = {key: b for key, b in pipe.kept.items() if key[0] in window}
    del pipe, driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks, compared, failed = check.compare(cfg, wl, prog, kept, device, root)
    run["check_s"] = time.perf_counter() - t
    return run, checks, compared, failed, peak
