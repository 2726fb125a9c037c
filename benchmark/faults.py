"""Faults planted under the timed path, for the checks that `correct`
catches them: each wraps a driver and breaks it in one way a step can
fail.  (The cells run on one card, so there is no exchange between chips
to leave out.)"""
import copy


class _Wrap:
    def __init__(self, driver):
        self.inner = driver

    def dispatch(self, pcm):
        return self.inner.dispatch(pcm)

    def drain(self, out, rows):
        return self.inner.drain(out, rows)

    def counters(self):
        return self.inner.counters()


class StaleState(_Wrap):
    """A step that returns its state unchanged: every step starts from the
    encoder's initial state."""

    def __init__(self, driver):
        super().__init__(driver)
        self.first = copy.copy(driver.state)

    def dispatch(self, pcm):
        out = self.inner.dispatch(pcm)
        self.inner.state = copy.copy(self.first)
        return out


class HalfBatch(_Wrap):
    """Half of the batch left out: the step's outputs of the second half of
    the stations are never computed (left zero)."""

    def dispatch(self, pcm):
        out = dict(self.inner.dispatch(pcm))
        wire = out["wire"].clone()
        wire[wire.shape[0] - wire.shape[0] // 2:] = 0
        out["wire"] = wire
        return out


class Altered(_Wrap):
    """An answer altered where it is produced: one byte of every station's
    device output flipped."""

    BYTE = 16

    def dispatch(self, pcm):
        out = dict(self.inner.dispatch(pcm))
        wire = out["wire"].clone()
        wire[:, self.BYTE] ^= 1
        out["wire"] = wire
        return out


FAULTS = {"stale_state": StaleState, "half_batch": HalfBatch, "altered": Altered}
