"""Each traffic generator repeats from its seed, and every seed gets the
same request sizes in another order."""

import itertools

import numpy as np

from portbench.kinds import closed_loop, train_class_seed
from portbench.tests import tiny


def test_class_seed_repeats():
    t = tiny.TRAFFIC["tiny_class_seed"]
    a, b = train_class_seed.train_inputs(t, 2 ** 31 + 3, "cpu"), train_class_seed.train_inputs(t, 2 ** 31 + 3, "cpu")
    c = train_class_seed.train_inputs(t, 4, "cpu")
    assert np.array_equal(a["xn"], b["xn"]) and np.array_equal(a["xo"], b["xo"])
    assert a["cls"] == b["cls"]
    assert not np.array_equal(a["xn"], c["xn"])
    assert a["xn"].shape == (20, 40, 40, 3) and a["xn"].dtype == np.uint8


def test_closed_loop_repeats_with_the_same_sizes():
    t = tiny.TRAFFIC["tiny_lots"]
    n = 3 * t["sizes"]["count"]
    a = list(itertools.islice(closed_loop.requests(t, 11), n))
    assert a == list(itertools.islice(closed_loop.requests(t, 11), n))
    b = list(itertools.islice(closed_loop.requests(t, 12), n))
    assert a != b
    assert sorted(s for _, s in a) == sorted(s for _, s in b)
    assert all(0 <= off and off + s <= t["pool"] for off, s in a + b)
    assert np.array_equal(closed_loop.pool(t, 11, "cpu"), closed_loop.pool(t, 11, "cpu"))


def test_sizes_follow_the_distribution():
    t = {"sizes": {"log_uniform": [1, 448], "count": 64}}
    s = closed_loop.request_sizes(t)
    assert s.min() == 1 and s.max() <= 448 and len(s) == 64
    assert np.all(np.diff(s) >= 0)
