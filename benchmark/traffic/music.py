"""Music-like programme: band-limited noise plus four moving tones under a
slow random envelope (a frozen copy of music_like in the repository's
tests/signals.py, which exercises tonal and noise maskers, scfsi patterns,
block switching and varying bit allocation)."""
import numpy as np


def _envelope(n, seed):
    rng = np.random.default_rng(seed)
    # slowly varying random envelope, 0..1
    knots = rng.uniform(0.05, 1.0, size=16)
    t = np.linspace(0, 15, n)
    return np.interp(t, np.arange(16), knots)


def make(n, channels, seed, rate=48000):
    """[channels, n] int16 of programme from `seed` (a whole number >= 0)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    k = np.hanning(31)
    k /= k.sum()
    chans = []
    for ch in range(channels):
        x = rng.normal(0, 0.08, n)
        x = np.convolve(x, k, mode="same")
        for f0, amp in [(441.3, 0.22), (1333.7, 0.12), (3777.1, 0.05), (9212.9, 0.02)]:
            # slight per-channel detune; off-bin frequencies
            x = x + amp * np.sin(2 * np.pi * (f0 * (1 + 0.001 * ch)) * t + 0.7 * ch)
        x *= _envelope(n, seed + 10 + ch)
        chans.append(x)
    x = np.clip(np.stack(chans), -0.999, 0.999)
    return (x * 32767.0).astype(np.int16)
