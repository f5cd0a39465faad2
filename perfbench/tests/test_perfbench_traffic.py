"""The traffic generator repeats exactly from the seed; seeds change
the order of one fixed set of sizes, not the sizes."""

import json

import numpy as np
import pytest

from perfbench.traffic import Traffic, quantile_lengths
from perfbench.tests.smoke import ROOT

MIXES = sorted(p.stem for p in (ROOT / "perfbench" / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_repeats_from_the_seed(mix):
    spec = json.loads((ROOT / "perfbench" / "traffic" / f"{mix}.json")
                      .read_text())
    seed = 2**31 + 12345
    a, b = Traffic(spec, seed, 1000), Traffic(spec, seed, 1000)
    for i in (0, 1, 17, spec["sizes"] + 3):
        pa, na = a.request(i)
        pb, nb = b.request(i)
        assert na == nb and np.array_equal(pa, pb)
    c = Traffic(spec, seed + 1, 1000)
    assert sorted(a.prompt_lens) == sorted(c.prompt_lens)
    assert sorted(a.output_lens) == sorted(c.output_lens)
    assert not np.array_equal(a.prompt_lens, c.prompt_lens)
    p = spec["prompt"]
    assert a.prompt_lens.min() >= p["min"] and a.prompt_lens.max() <= p["max"]
    assert abs(np.median(a.prompt_lens) - p["median"]) <= 0.02 * p["median"]
    assert not np.array_equal(a.request(0)[0][:8], a.request(1)[0][:8])


def test_quantiles_are_clipped_lognormal():
    d = {"median": 100, "sigma": 1.0, "min": 50, "max": 400}
    q = quantile_lengths(d, 1000)
    assert q.min() == 50 and q.max() == 400
    assert (q == 50).mean() == pytest.approx(0.24, abs=0.01)   # P(z < -ln 2)


def test_prompt_blocks_cover_every_padded_length():
    spec = {"clients": 1, "sizes": 4,
            "prompt": {"median": 300, "sigma": 0.5, "min": 130, "max": 700},
            "output": {"median": 4, "sigma": 0.1, "min": 2, "max": 8}}
    t = Traffic(spec, 1, 10)
    assert t.prompt_blocks(128) == [256, 384, 512, 640, 700]
