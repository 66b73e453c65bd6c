"""The traffic generator: Table 2's sizes, the same work for every seed in
another order, and the same requests for the same seed."""
import collections
import json

import numpy as np
import perfbench_cases as cases  # noqa: F401
import pytest

from perfbench.harness import spec
from perfbench.traffic import generator
from repro_torch.serving.workload import DATASETS

MIXES = ["sharegpt", "offline"]


def mix(name):
    return json.loads((spec.BENCH_DIR / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_mix_is_table_2(name):
    m = mix(name)
    ds = DATASETS[m["dataset"]]
    assert (tuple(m["p25"]), tuple(m["p50"]), tuple(m["p75"])) == (ds.p25, ds.p50, ds.p75)
    assert (m["ttft_limit_s"], m["tpot_limit_s"]) == (ds.ttft_slo_s, ds.tpot_slo_s)
    assert m["weights"] == [0.25, 0.5, 0.25]


def test_longbench_is_table_2():
    """Table 2's longbench row, which Open questions' cells would use."""
    ds = DATASETS["longbench"]
    assert (ds.p25, ds.p50, ds.p75) == ((1134, 201), (1495, 275), (1817, 352))
    assert (ds.ttft_slo_s, ds.tpot_slo_s) == (15.0, 0.15)


def test_same_seed_same_requests():
    a = generator.generate(mix("sharegpt"), 2 ** 31 + 5, 64000, horizon_s=60, rate=5)
    b = generator.generate(mix("sharegpt"), 2 ** 31 + 5, 64000, horizon_s=60, rate=5)
    assert [(r.due_s, r.output_len) for r in a] == [(r.due_s, r.output_len) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    c = generator.generate(mix("sharegpt"), 2 ** 31 + 6, 64000, horizon_s=60, rate=5)
    assert [r.due_s for r in a] != [r.due_s for r in c]


def test_every_seed_gets_the_same_work_in_another_order():
    m = mix("sharegpt")
    runs = [generator.generate(m, s, 64000, horizon_s=80, rate=6) for s in (1, 2, 3 ** 20)]
    sizes = [collections.Counter((len(r.prompt), r.output_len) for r in reqs) for reqs in runs]
    assert sizes[0] == sizes[1] == sizes[2]
    assert sizes[0] == {(24, 24): 120, (160, 140): 240, (510, 357): 120}
    gaps = [sorted(np.diff([0.0] + [r.due_s for r in reqs])) for reqs in runs]
    np.testing.assert_allclose(gaps[0], gaps[1])
    assert len(runs[0]) == 480 and abs(runs[0][-1].due_s - 80) < 0.5
    for reqs in runs:
        assert all(r.prompt.dtype == np.int32 and 0 <= r.prompt.min() and r.prompt.max() < 64000
                   for r in reqs)


def test_blocks_hold_the_mixture_in_every_prefix():
    """The whole run holds one P25, two P50 and one P75 in every four, in an
    order shuffled whole: runs of long requests come as often as a mixture's
    independent draws bring them, not one a block."""
    reqs = generator.generate(mix("offline"), 11, 151936)
    assert len(reqs) == 1200 and all(r.due_s == 0.0 for r in reqs)
    out = [r.output_len for r in reqs]
    assert collections.Counter(out) == {24: 300, 140: 600, 357: 300}
    assert generator.mean_output(mix("offline")) == pytest.approx(165.25)
    blocks = [sorted(out[i:i + 4]) for i in range(0, 1200, 4)]
    assert sum(b == [24, 140, 140, 357] for b in blocks) < 60     # ~28 of 300 by chance
    longest = max(len(run) for run in "".join("L" if o == 357 else "." for o in out).split("."))
    assert longest >= 4
    with pytest.raises(ValueError):
        generator.sizes(mix("offline"), 1201, np.random.default_rng(0))


def test_gaps_are_exponential_quantiles_dealt_into_blocks():
    """Each gap is an exponential quantile, and the gaps are shuffled whole:
    the span of 16 arrivals varies as Poisson's does (coefficient of
    variation 1/4), not held to 16 / rate."""
    g = generator.gaps(1008, 4.0, np.random.default_rng(0))
    q = (np.arange(1008) + 0.5) / 1008
    quantiles = -np.log1p(-q) / 4.0
    np.testing.assert_allclose(np.sort(g), quantiles)
    assert g.mean() == pytest.approx(0.25, rel=0.01)
    spans = g.reshape(-1, 16).sum(axis=1)
    assert spans.mean() == pytest.approx(4.0, rel=0.01)
    assert 0.2 <= spans.std() / spans.mean() <= 0.3


def test_bad_mixes_are_refused():
    with pytest.raises(ValueError):
        generator.generate(dict(mix("sharegpt"), arrivals="bursty"), 1, 10, 10, 1)
    with pytest.raises(ValueError):
        generator.generate(mix("sharegpt"), 1, 10)
    with pytest.raises(ValueError):
        generator._block([1.0, 2 ** 0.5, 1.0])
