"""The traffic generator repeats per seed, draws its stated ranges, and
gives every seed the same work; the percentiles refuse a thin tail."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
from conftest import ROOT

from asrbench.stats import percentile, spread
from asrbench.traffic import SAMPLE_RATE, Plan

MIXES = {p.stem: json.loads(p.read_text()) for p in (ROOT / "asrbench" / "workloads").glob("*.json")}
SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 40 + 3)


def _take(gen, n):
    return [next(gen) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_plan_repeats_per_seed(name):
    mix = MIXES[name]
    a, b = Plan(mix, 2 ** 33 + 1), Plan(mix, 2 ** 33 + 1)
    ra, rb = _take(a.closed(), 60), _take(b.closed(), 60)
    assert [(r.kind, r.n_samples, r.max_tokens, r.n_words) for r in ra] == \
           [(r.kind, r.n_samples, r.max_tokens, r.n_words) for r in rb]
    for r in ra[:5]:
        assert np.array_equal(a.pcm(r), b.pcm(r)) and a.pcm(r).dtype == np.int16
    other = _take(Plan(mix, 5).closed(), 60)
    assert [r.kind for r in other] != [r.kind for r in ra]
    assert not np.array_equal(Plan(mix, 5).pcm(ra[0]), a.pcm(ra[0]))


@pytest.mark.parametrize("name", sorted(MIXES))
def test_plan_draws_its_ranges(name):
    mix = MIXES[name]
    lo, hi = mix["audio_s"]
    for seed in SEEDS:
        plan = Plan(mix, seed)
        reqs = _take(plan.closed(), 2 * mix["sizes"])
        secs = [r.seconds for r in reqs]
        assert lo < min(secs) and max(secs) < hi
        # each full cycle is the whole set of lengths, once
        assert sorted(r.kind for r in reqs[:mix["sizes"]]) == list(range(mix["sizes"]))
        for r in reqs:
            assert len(plan.pcm(r)) == r.n_samples == round(r.seconds * SAMPLE_RATE)
            if "tokens_per_audio_s" in mix:
                assert r.max_tokens == round(mix["tokens_per_audio_s"] * r.seconds)
            if "max_tokens" in mix:
                assert r.max_tokens == mix["max_tokens"]
            if "words_per_audio_s" in mix:
                assert r.n_words == round(mix["words_per_audio_s"] * r.seconds)


def test_short_mix_tokens():
    reqs = _take(Plan(MIXES["asr-short-cli"], 1).closed(), 48)
    assert 7 <= min(r.max_tokens for r in reqs) and max(r.max_tokens for r in reqs) <= 53


def test_any_stretch_averages_the_mean():
    """Lengths come next to their mirrors: every even stretch's mean
    length is the set's."""
    mix = MIXES["asr-longform-cli"]
    plan = Plan(mix, 99)
    mean = sum(plan.lengths) / len(plan.lengths)
    reqs = _take(plan.closed(), 100)
    for n in (10, 36, 100):
        assert abs(sum(r.seconds for r in reqs[:n]) / n - mean) < 1e-3


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_gaps(seed):
    mix = dict(MIXES["asr-longform-cli"], rate_per_s=16.0)
    reqs = Plan(mix, seed).schedule(40.0)
    assert len(reqs) == 640
    due = [r.t_due for r in reqs]
    gaps = np.diff(due)
    assert due[0] == 0.0 and (gaps > 0).all()
    # the exponential's quantiles: mean 1/rate, coefficient of variation ~1
    assert 38.5 < due[-1] < 40.0
    assert abs(gaps.mean() - 1 / 16.0) < 0.005 and 0.85 < gaps.std() / gaps.mean() < 1.1
    assert [r.t_due for r in Plan(mix, seed).schedule(40.0)] == due
    other = [r.t_due for r in Plan(mix, seed + 1).schedule(40.0)]
    assert other != due and len(other) == len(due)


def test_percentile_refuses_a_thin_tail():
    with pytest.raises(ValueError):
        percentile(list(range(99)), 90)
    assert percentile(list(range(100)), 90) == pytest.approx(89.1)
    with pytest.raises(ValueError):
        percentile(list(range(19)), 50)
    assert percentile(list(range(21)), 50) == 10
    assert percentile([1.0] * 99 + [float("inf")], 90) == 1.0
    assert math.isinf(percentile([1.0] * 80 + [float("inf")] * 20, 90))


def test_spread():
    assert spread([10, 10, 10, 10]) == 0.0
    assert spread([9, 10, 11, 12, 8, 10]) == pytest.approx(0.25)
