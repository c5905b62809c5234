"""The traffic generator: seeded, distinct frames; a uniform reservoir."""

import numpy as np

from benchmark import generator


def test_same_seed_same_frames_other_seed_other_frames():
    big = 2**33 + 12345  # seeds given to the benchmark may exceed 32 bits
    a = np.asarray(generator.make_frames(generator.seed_key(big), 6, 16, 64))
    b = np.asarray(generator.make_frames(generator.seed_key(big), 6, 16, 64))
    c = np.asarray(generator.make_frames(generator.seed_key(big + 1), 6, 16, 64))
    d = np.asarray(generator.make_frames(generator.seed_key(big + 2**32), 6, 16, 64))
    assert a.shape == (6, 3, 16, 64) and a.dtype == np.float32
    assert np.array_equal(a, b)
    assert not np.allclose(a, c) and not np.allclose(a, d)
    assert a.min() >= 0.0 and a.max() <= 1.0


def test_frames_of_a_ring_are_distinct():
    f = np.asarray(generator.make_frames(generator.seed_key(7), 12, 16, 64)).reshape(12, -1)
    gaps = [np.abs(f[i] - f[j]).max() for i in range(12) for j in range(i + 1, 12)]
    assert min(gaps) > 1e-3


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(20)
    for trial in range(2000):
        r = generator.Reservoir(2, np.random.default_rng(trial))
        for i in range(20):
            r.offer(i)
        counts[r.items] += 1
    assert counts.min() > 140 and counts.max() < 260  # expectation 200
    r1, r2 = (generator.Reservoir(3, np.random.default_rng(5)) for _ in range(2))
    for i in range(50):
        r1.offer(i)
        r2.offer(i)
    assert r1.items == r2.items
