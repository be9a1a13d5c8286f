"""The traffic generator: the same seed draws the same requests, another
seed another order of the same work."""

import itertools
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from pbench import traffic

BENCH = Path(__file__).resolve().parent.parent
CELLS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))


def _load(cell):
    return json.loads((BENCH / "workloads" / f"{cell}.json").read_text())


def _take(workload, seed, n):
    return list(itertools.islice(traffic.draw(workload, seed), n))


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_requests(cell):
    w = _load(cell)
    a, b = _take(w, 2**33 + 7, 100), _take(w, 2**33 + 7, 100)
    assert a == b


@pytest.mark.parametrize("cell", CELLS)
def test_other_seed_other_order_same_work(cell):
    w = _load(cell)
    block = w["block"]
    a, b = _take(w, 11, 3 * block + 1), _take(w, 12, 3 * block + 1)
    assert [r.tokens for r in a] != [r.tokens for r in b]
    for k in range(3):
        ra, rb = a[k * block : (k + 1) * block], b[k * block : (k + 1) * block]
        assert Counter(len(r.tokens) for r in ra) == Counter(len(r.tokens) for r in rb)
        assert Counter(r.route for r in ra) == Counter(r.route for r in rb)
        assert sum(r.greedy for r in ra) == sum(r.greedy for r in rb) == round(w["greedy_share"] * block)
        if w["loop"] == "open":
            ga = np.diff([r.due for r in a[k * block : (k + 1) * block + 1]])
            gb = np.diff([r.due for r in b[k * block : (k + 1) * block + 1]])
            assert len(ga) == block and sorted(np.round(ga, 9)) == sorted(np.round(gb, 9))


def test_lengths_follow_the_issue_distribution():
    w = _load("bf16-single-stream")
    lengths = traffic.block_lengths(w)
    assert min(lengths) >= 4 and max(lengths) == 50
    assert 21 <= np.mean(lengths) <= 23  # lognormal median 20, sigma 0.5, clipped: mean ~22
    assert sorted(lengths)[len(lengths) // 2] in (20, 21)
    assert [traffic.frames_for_tokens(n) for n in (4, 20, 50)] == [42, 109, 234]


def test_open_loop_rate_is_exact_per_block():
    w = _load("int8-b8-mixed-open")
    block = w["block"]
    reqs = _take(w, 5, block + 1)
    assert reqs[block].due == pytest.approx(block / w["rate_per_s"])


def test_ids_in_vocabulary_and_budgets():
    w = _load("int8-b8-saturated")
    for r in _take(w, 2**40, 200):
        assert all(0 <= t < w["vocab"] for t in r.tokens)
        assert r.frames == traffic.frames_for_tokens(len(r.tokens))
        assert r.temperature in (0.0, w["temperature"])
