"""The mixes' inputs are made from the seed alone."""
from __future__ import annotations

import numpy as np
import pytest

from h100bench_helpers import common, tiny_config

from benchmark import serving
from benchmark.drivers import train as train_driver

SEEDS = [0, 2**31 + 17, 2**32 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_requests_by_seed(seed):
    a = serving.chunk_embeddings(seed, 3, 8, 16)
    b = serving.chunk_embeddings(seed, 3, 8, 16)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, serving.chunk_embeddings(seed + 1, 3, 8, 16))
    rids = [3 * 8 + 2, 5]
    got = serving.request_embeddings(seed, rids, 8, 16)
    assert np.array_equal(got[0], a[2])


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_by_seed(seed):
    cfg = tiny_config("flagship-train-coco")
    tr = common.traffic_file("train-coco-b30")
    a = train_driver.make_batch(seed, 4, tr, cfg)
    b = train_driver.make_batch(seed, 4, tr, cfg)
    for k in a:
        assert np.array_equal(a[k], b[k])
    lens = (a["tokens"] != 0).sum(1)
    assert lens.min() >= tr["caption_tokens"][0]
    assert lens.max() <= tr["caption_tokens"][1]
    K = cfg["model"]["mapper"]["prefix_length"]
    assert np.array_equal(a["mask"][:, K:], (a["tokens"] != 0).astype(np.float32))
    c = train_driver.make_batch(seed, 5, tr, cfg)
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert 0 <= train_driver.noise_base(seed) < 2**31


@pytest.mark.parametrize("seed", SEEDS)
def test_check_sample(seed):
    """The check's sample has exactly n requests, the longest among them,
    and is the same for the same seed."""
    served = {r: [1] * (5 + (r * 7919) % 60) for r in range(200)}
    longest = max(served, key=lambda r: len(served[r]))
    for n in (1, 16, 48):
        got = serving.sample_ids(seed, served, n)
        assert len(got) == len(set(got)) == n
        assert longest in got
        assert got == serving.sample_ids(seed, served, n)
    assert serving.sample_ids(seed, {3: [1], 4: [2]}, 48) == [3, 4]
