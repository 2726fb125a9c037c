"""The measured loop: the fleet runtime's one-step-deep pipeline.

Step k: the harness hands the program the step's PCM through the runtime's
own transfers (`upload`), the driver dispatches the step, and the copy of
its outputs into pinned host memory is enqueued (`download`); then step
k - 1 is drained: its copies are waited for and the driver emits its bytes.
Two dispatch-and-drain rounds warm up, then the window runs until the
first drain that ends after `seconds`.  Every step's host times are kept.
"""
import time
from contextlib import nullcontext


class Pipeline:
    def __init__(self, driver, programme, io, keep, span=None, clock=time.perf_counter):
        """keep(k) -> the stations whose drained bytes of step k are kept
        (for the check); span(name) -> a context that names a host phase
        in a trace (none by default)."""
        self.driver, self.prog, self.io, self.keep = driver, programme, io, keep
        self.span = span or (lambda name: nullcontext())
        self.clock = clock
        self.steps = {}
        self.kept = {}
        self.k = 0
        self.pending = None

    def dispatch(self):
        k, clock = self.k, self.clock
        t0 = clock()
        with self.span("bench.upload"):
            pcm = self.io.upload(self.prog.batch(k))
        t1 = clock()
        with self.span("bench.dispatch"):
            out = self.driver.dispatch(pcm)
        t2 = clock()
        with self.span("bench.download"):
            handle = self.io.download(out)
        self.steps[k] = {"k": k, "hand": t0, "upload_s": t1 - t0, "dispatch_s": t2 - t1,
                         "download_s": clock() - t2}
        prev, self.pending = self.pending, (k, handle)
        self.k += 1
        return prev

    def drain(self, item):
        k, handle = item
        clock = self.clock
        t0 = clock()
        with self.span("bench.wait"):
            out = self.io.wait(handle)
        t1 = clock()
        rows = self.keep(k)
        with self.span("bench.drain"):
            data = self.driver.drain(out, rows)
        t2 = clock()
        self.steps[k].update(wait_s=t1 - t0, drain_s=t2 - t1, done=t2)
        for i, b in zip(rows, data):
            self.kept[(k, i)] = b

    def round(self):
        """Dispatch the next step, then drain the one before it."""
        prev = self.dispatch()
        if prev is not None:
            self.drain(prev)
        return prev

    def finish(self):
        if self.pending is not None:
            self.drain(self.pending)
            self.pending = None


def run_window(pipe, seconds, warm=2):
    """Warm-up, then the window.  Returns (t0, t1, ks): the window's start
    and end on the host clock and the steps it drained."""
    pipe.round()
    for _ in range(warm):
        pipe.round()
    t0 = pipe.clock()
    ks = []
    while True:
        k, _ = pipe.round()
        ks.append(k)
        t1 = pipe.steps[k]["done"]
        if t1 - t0 >= seconds:
            return t0, t1, ks
