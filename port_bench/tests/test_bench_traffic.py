"""The general generator: a round's composition does not depend on the
seed, its content and order do, and a mix is a data file found by name."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from conftest import BENCH

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_round_composition_is_the_same_for_two_seeds(mix):
    from port_bench.traffic import Traffic

    t = Traffic(json.loads((BENCH / "traffic" / f"{mix}.json").read_text()), 4)
    a, b = t.round(2 ** 31 + 11, 0), t.round(7, 0)
    assert sorted(a, key=lambda x: x.items) == sorted(b, key=lambda x: x.items)
    assert sum(len(x.items) for x in a) == len(t.items)


def test_content_and_order_follow_the_seed():
    from port_bench.traffic import Traffic

    spec = {"kind": "train", "rates": [8000, 16000, 22050, 24000, 32000], "crop_samples": 800,
            "last_item_fraction": 0.85}
    t = Traffic(spec, 2)
    seed = 3 * 2 ** 31 + 5
    c1, c2 = t.content(seed, 0, "cpu"), t.content(seed, 0, "cpu")
    assert all(np.array_equal(x["noisy"], y["noisy"]) for x, y in zip(c1, c2))
    assert not np.array_equal(c1[0]["noisy"], t.content(seed + 1, 0, "cpu")[0]["noisy"])
    orders = {tuple(b.fs for b in t.round(s, 0)) for s in range(6)}
    assert len(orders) > 1
    b = t.batches()[0]
    assert b.lengths == (800, 680) and b.bucket == 8000


def test_batched_mix_groups_by_rate_and_bucket_with_filler_rows():
    from port_bench.traffic import Traffic

    t = Traffic(json.loads((BENCH / "traffic" / "enhance_b8.json").read_text()))
    bs = t.batches()
    assert [(b.fs, b.bucket) for b in bs] == sorted((b.fs, b.bucket) for b in bs)
    assert all(b.rows == 8 for b in bs)
    fill = sum(len(b.items) for b in bs) / sum(b.rows for b in bs)
    assert 0.4 < fill < 0.5  # 336 files in 91 batches of 8


def test_a_new_mix_dropped_into_a_copy_is_found_and_runs(tiny):
    """A later change adds a cell by adding a data file and an entry."""
    from port_bench.harness import Cell

    mix = {"kind": "enhance", "rates": [16000], "seconds": [0.25, 0.4, 0.6], "batch_size": 2,
           "check_files": 2}
    (tiny.dir / "traffic" / "pairs.json").write_text(json.dumps(mix))
    tiny.bench["workloads"].append({"name": "bsrnn196.pairs", "config": "bsrnn196",
                                    "traffic": "pairs", "chips": 1, "why": "test"})
    for m in tiny.bench["end_to_end"] + tiny.bench["per_layer"]:
        if "workloads" in m and m["name"].endswith(("enhance_rate", ".enhance")):
            m["workloads"].append("bsrnn196.pairs")
    out = Cell(tiny, "bsrnn196.pairs", 5, 0.0, False, "cpu", time.perf_counter()).run()
    assert out["correct"] and out["attempted"] == 3
    assert set(out["metrics"]) == {"enhance_rate", "setup_s"}
