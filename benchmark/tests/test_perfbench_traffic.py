"""The traffic pool: distinct mixtures, the same for the same mix seed, and
a failure past its end."""
import numpy as np
import pytest

from benchmark.tests import tiny
from benchmark.traffic import generator

SEED = 2 ** 40 + 11  # wider than 32 bits, as the seeds of a check


@pytest.fixture(scope="module")
def pools():
    cfg, tr = tiny.config(), tiny.traffic(pool=6)
    tr.update(scenes=2, seed=SEED)
    other = dict(tr, seed=SEED + 1)
    return (generator.make_pool(tr, cfg, "cpu"),
            generator.make_pool(tr, cfg, "cpu"),
            generator.make_pool(other, cfg, "cpu"))


def test_same_seed_same_pool_and_all_distinct(pools):
    a, b, c = pools
    assert len(a) == 6
    for i in range(len(a)):
        assert np.array_equal(a.take(i)[0], b.take(i)[0])
        assert not np.array_equal(a.take(i)[0], c.take(i)[0])
    keys = {a.take(i)[0].tobytes() for i in range(len(a))}
    assert len(keys) == len(a)
    assert a.take(0)[0].shape == (7, 24000)
    assert a.take(0)[0].dtype == np.float32


def test_exhausted_pool_fails(pools):
    with pytest.raises(RuntimeError, match="exhausted"):
        pools[0].take(len(pools[0]))


def test_per_mixture_layouts_differ():
    tr = tiny.traffic("redeploy_3talkers", pool=3)
    pool = generator.make_pool(tr, tiny.config(), "cpu")
    arrays = [pool.take(i)[1] for i in range(3)]
    assert all(a.shape == (7, 3) for a in arrays)
    assert not np.array_equal(arrays[0], arrays[1])
    roi = pool.take(0)[2]
    assert len(roi) == 6 and roi[0] < roi[1] and roi[2] < roi[3]
