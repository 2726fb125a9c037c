"""The stations' audio, made in set-up.

One programme of `seconds` per channel (traffic/<kind>.py, from the
traffic's own `seed`) is read by every station at its own offset: station i
reads sample (base + i * stride + t) mod L at time t, so consecutive steps
carry consecutive audio and the programme loops.  `base` is drawn from the
run's --seed.  So every seed gives the same audio material and the same
sizes in another order: the stations together cover the whole programme
in every step, and the seed does not change how much work a step is
(the MP2 allocator tail and the DAB+ recovery check run to the batch's
hardest station).  A step's batch [1, S, ch, n] is a strided view into
one tiled copy of the programme, made ahead of the window: the window pays
the program's upload (the copy into pinned memory and the H2D), not the
generator.
"""
import numpy as np

SEED_MASK = (1 << 63) - 1


class Programme:
    def __init__(self, traffic, channels, samples_per_step, seed, make, rate=48000):
        """make(n, channels, seed, rate): the programme kind's generator."""
        prog = traffic["programme"]
        n = samples_per_step
        L = int(round(prog["seconds"] * rate))
        self.S, self.n, self.L, self.channels = traffic["stations"], n, L, channels
        self.stride = int(traffic["offset"]["stride"])
        self.base = int(np.random.default_rng([int(seed) & SEED_MASK, 1]).integers(0, L))
        self.audio = make(L, channels, prog["seed"], rate)
        # tiled so that every station's step is a contiguous slice
        need = self.base + (self.S - 1) * self.stride + L + n
        self.tiled = np.stack([np.resize(a, need) for a in self.audio])

    def offset(self, i):
        return self.base + i * self.stride

    def batch(self, k):
        """Step k of every station: a [1, S, ch, n] int16 view (no copy)."""
        start = self.base + (k * self.n) % self.L
        t = self.tiled[:, start:]
        item = t.itemsize
        return np.lib.stride_tricks.as_strided(
            t, shape=(1, self.S, self.channels, self.n),
            strides=(0, self.stride * item, t.strides[0], item))

    def station(self, i, k0, steps):
        """Station i's audio of steps k0 .. k0 + steps - 1: [ch, steps * n]."""
        t = (self.offset(i) + k0 * self.n + np.arange(steps * self.n)) % self.L
        return self.audio[:, t]
