"""Each mix is a function of the seed alone, and every seed sends the same sizes."""

import itertools

import numpy as np
import pytest

from perfbench.harness.spec import Spec
from perfbench.harness.traffic import RealLines, chunks_of, requests

SEEDS = (0, 2**31 + 11, 123456789)


@pytest.fixture(scope="module")
def spec(root):
    return Spec(root)


@pytest.fixture(scope="module")
def real(spec):
    return RealLines(spec.dir / "data")


def mixes(spec):
    """The mixes of requests (the training mix is a set of samples: test_train_samples_*)."""
    names = {w["traffic"] for w in spec.benchmark["workloads"]}
    return sorted(n for n in names if "lines_per_request" in spec.traffic(n))


def take(mix, real, seed, n):
    return list(itertools.islice(requests(mix, real, seed), n))


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_requests(spec, real, seed):
    for name in mixes(spec):
        mix = spec.traffic(name)
        a, b = take(mix, real, seed, 6), take(mix, real, seed, 6)
        assert [r.parts for r in a] == [r.parts for r in b]
        assert all(np.array_equal(x, y) for ra, rb in zip(a, b) for x, y in zip(ra.lines, rb.lines))


def test_other_seed_other_requests(spec, real):
    for name in mixes(spec):
        mix = spec.traffic(name)
        assert [r.parts for r in take(mix, real, 1, 4)] != [r.parts for r in take(mix, real, 2, 4)]


def test_every_seed_sends_the_same_sizes(spec, real):
    mix = spec.traffic("pages_real_lines")
    lo, hi = mix["lines_per_request"]["low"], mix["lines_per_request"]["high"]
    for seed in SEEDS:
        sizes = sorted(len(r.lines) for r in take(mix, real, seed, hi - lo + 1))
        assert sizes == list(range(lo, hi + 1))


def test_joined_lines_span_their_widths(real):
    mix = {"lines_per_request": {"low": 128, "high": 128},
           "line": {"source": "real_lines", "join": {"gap_px": 12, "width_px": [1000, 4000]}}}
    lo, hi = mix["line"]["join"]["width_px"]
    req = take(mix, real, 5, 1)[0]
    assert len(req.lines) == 128
    assert all(lo <= w < hi and ln.shape == (48, w) for w, ln in zip(req.widths, req.lines))
    strata = sorted((w - lo) * 128 / (hi - lo) for w in req.widths)  # one width in each stratum, floored to a px
    assert all(i - 0.05 < s < i + 1 for i, s in enumerate(strata))
    assert chunks_of(lo) == 12 and chunks_of(hi - 1) == 48


def test_train_samples_same_seed_same_set(spec, real):
    import json

    from perfbench.harness.traffic import train_samples

    mix = spec.traffic("train_real_lines")
    texts = json.loads((spec.dir / "data" / "real_lines.json").read_text())["texts"]
    a, b = train_samples(mix, real, texts, 9), train_samples(mix, real, texts, 9)
    assert len(a) == mix["samples"] and [x[2] for x in a] == [x[2] for x in b]
    assert [x[2] for x in a] != [x[2] for x in train_samples(mix, real, texts, 10)]
    assert all(x[0] is real.lines[x[2][0]] and x[1] == texts[x[2][0]] for x in a)


@pytest.mark.parametrize("samples", [4096, 40])
def test_train_samples_every_seed_the_same_lines(spec, real, samples):
    import json

    from perfbench.harness.traffic import train_samples

    mix = {**spec.traffic("train_real_lines"), "samples": samples}
    texts = json.loads((spec.dir / "data" / "real_lines.json").read_text())["texts"]
    counts = [np.bincount([x[2][0] for x in train_samples(mix, real, texts, s)], minlength=64) for s in SEEDS]
    assert all(np.array_equal(np.sort(c), np.sort(counts[0])) for c in counts)
    assert counts[0].max() - counts[0].min() <= 1 and counts[0].sum() == samples
