"""The programme and each station's offset come from the seed alone."""
import numpy as np
import pytest

from benchmark import registry
from benchmark.traffic.programme import Programme

TRAFFIC = {"stations": 7, "programme": {"kind": "music", "seconds": 0.6, "seed": 1234},
           "offset": {"stride": 997}}
MAKE = registry.module("traffic", "music").make


def prog(seed, n=1152, channels=2):
    return Programme(TRAFFIC, channels, n, seed, MAKE)


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 11, 2**40 + 3, -9])
def test_same_seed_same_audio(seed):
    a, b = prog(seed), prog(seed)
    assert a.base == b.base
    for k in (0, 1, 30):
        assert np.array_equal(a.batch(k), b.batch(k))


def test_seeds_reorder_the_same_programme():
    """A seed moves every station's offset; the material and the sizes
    stay (the traffic's own seed makes the programme)."""
    a, b = prog(1), prog(2)
    assert a.base != b.base and not np.array_equal(a.batch(3), b.batch(3))
    assert np.array_equal(a.audio, b.audio) and a.batch(3).shape == (1, 7, 2, 1152)
    other = Programme(dict(TRAFFIC, programme=dict(TRAFFIC["programme"], seed=5)), 2, 1152, 1,
                      MAKE)
    assert not np.array_equal(other.audio, a.audio)


@pytest.mark.parametrize("n", [1152, 5760])
def test_each_station_reads_its_own_offset_continuously(n):
    p = prog(2**31 + 11, n)
    for i in range(7):
        for k in (0, 4, 11):     # 11 steps of 5760 pass the programme's end: it loops
            assert np.array_equal(p.batch(k)[0, i], p.station(i, k, 1))
            assert p.station(i, k, 1)[:, 0].tolist() == \
                p.audio[:, (p.base + i * 997 + k * n) % p.L].tolist()
        both = p.station(i, 3, 2)
        assert np.array_equal(both, np.concatenate([p.batch(3)[0, i], p.batch(4)[0, i]], 1))
    assert not np.array_equal(p.batch(2)[0, 0], p.batch(2)[0, 1])


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_the_fixed_check_sample_spans_the_batch(seed):
    """One checked station from each of 16 equal blocks, the same at every
    step, drawn anew by another seed."""
    from benchmark.check import keep_rule
    rows = keep_rule({"stations": 16}, 8192, seed)(5)
    assert rows == keep_rule({"stations": 16}, 8192, seed)(9)
    assert [r // 512 for r in rows] == list(range(16))
    assert keep_rule({"stations": 16}, 8192, seed + 1)(5) != rows
    assert keep_rule({"stations": 16}, 4, seed)(0) == [0, 1, 2, 3]
