"""alloc_kernel_launches.mp2: the launches counted on the program's
mp2.alloc.kernel spans per step, on a synthetic span list and on the port's
own spans (the CPU's plain allocator keeps none, so no figure; on a card,
`-m cuda`, one launch per step)."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import registry

MS = 1_000_000          # ns


def span(name, start_ms, end_ms, parent=None, **counts):
    return SimpleNamespace(name=name, parent=parent, start_ns=int(start_ms * MS),
                           end_ns=int(end_ms * MS), counts=counts)


def mp2_step(t, kernel=True, passes=3):
    """One MP2 step from t ms: psy 10 ms, then the allocation, 4 ms around
    the kernel's 0.5 ms span (launches=1) or 20 ms holding the plain tail
    of `passes` syncs of 1 ms."""
    step = span("mp2.step", t, t + 40)
    out = [span("mp2.psy", t + 2, t + 12, step)]
    if kernel:
        alloc = span("mp2.alloc", t + 12, t + 16, step)
        out.append(span("mp2.alloc.kernel", t + 13, t + 13.5, alloc, launches=1))
    else:
        alloc = span("mp2.alloc", t + 12, t + 32, step)
        tail = span("mp2.alloc.tail", t + 15, t + 30, alloc, passes=passes)
        out += [span("mp2.tail.sync", t + 16 + 2 * i, t + 17 + 2 * i, tail)
                for i in range(passes)] + [tail]
    return out + [alloc, span("mp2.quantize", t + 32, t + 35, step), step]


@pytest.fixture
def store(monkeypatch):
    """Hands the readers `kept` in place of the program's store."""
    from odr_audioenc_tpu_torch import obs
    kept = []
    monkeypatch.setattr(obs, "spans", lambda: list(kept))
    return kept


def read(name, window_end_s=1.0):
    return registry.module("metrics", name).read({"window": (0.0, window_end_s), "trace": {}})


def test_alloc_kernel_launches_counts_launches_per_step(store):
    store += mp2_step(2000) + mp2_step(2100)
    assert read("alloc_kernel_launches.mp2") == pytest.approx(1.0)
    # the allocation's host time keeps its meaning; no tail, no sync to read
    assert read("alloc_ms.mp2") == pytest.approx(4.0)
    assert read("alloc_tail_passes.mp2") is None and read("sync_wait_ms") is None


def test_alloc_kernel_launches_left_out_for_the_plain_allocator(store):
    store += mp2_step(2000, kernel=False) + mp2_step(2100, kernel=False, passes=5)
    assert read("alloc_kernel_launches.mp2") is None
    assert read("alloc_tail_passes.mp2") == pytest.approx(4.0)


def test_alloc_kernel_launches_left_out_without_a_traced_slice(store):
    store += mp2_step(2000)
    assert registry.module("metrics", "alloc_kernel_launches.mp2").read(
        {"window": (0.0, 1.0), "trace": None}) is None


def port_run(device, steps=3):
    """The port's MP2 step on `device` (8 stations of mux_mix's pattern, psy
    1 float32, frame pack) `steps` times inside obs.enabled(); returns the
    run the readers take: its window ends before the first step."""
    from odr_audioenc_tpu_torch import obs
    from odr_audioenc_tpu_torch.mp2.model import Mp2Encoder, make_config
    pattern = [(128, "j"), (192, "s"), (96, "j"), (160, "s")]
    cfg = make_config([{"rate": 48000, "bitrate": b, "mode": m} for b, m in pattern * 2])
    enc = Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device=device,
                     pack_on_device="frame")
    rng = np.random.default_rng(3)
    pcm = torch.as_tensor(rng.integers(-8000, 8000, (steps, 8, 2, 1152)).astype(np.int16),
                          device=device)
    xpad = torch.zeros((8,), dtype=torch.int64, device=device)
    obs.clear()
    start = time.perf_counter()
    with obs.enabled():
        state = enc.init_state()
        for t in range(steps):
            state, _ = enc._encode_step(state, pcm[t], xpad)
    return {"window": (0.0, start), "trace": {}}


def test_port_spans_on_the_cpu_give_no_kernel_figure():
    run = port_run(torch.device("cpu"))
    m = {name: registry.module("metrics", name).read(run)
         for name in ("alloc_kernel_launches.mp2", "alloc_tail_passes.mp2", "alloc_ms.mp2")}
    assert m["alloc_kernel_launches.mp2"] is None
    assert m["alloc_tail_passes.mp2"] >= 1.0 and m["alloc_ms.mp2"] > 0


@pytest.mark.cuda
def test_port_spans_on_the_card_read_one_launch_per_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run = port_run(torch.device("cuda", 0))
    m = {name: registry.module("metrics", name).read(run)
         for name in ("alloc_kernel_launches.mp2", "alloc_tail_passes.mp2", "alloc_ms.mp2")}
    assert m["alloc_kernel_launches.mp2"] == pytest.approx(1.0)
    assert m["alloc_tail_passes.mp2"] is None and m["alloc_ms.mp2"] > 0
