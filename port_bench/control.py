"""Readings that the limits of ``correct`` are set from, for one cell, in
one process: for each seed a run of the cell (one round in its window)
and the numbers it compares, and beside them the numbers of the reference
put in the program's place as a control (computed in the precision below
the configuration's: ``tf32`` for the float32 training cells, ``fp8`` for
the bfloat16 enhancement cells) or as a planted fault (``half_batch``).

    python3 port_bench/control.py --workload bsrnn196.train --seeds 1,2,3 \\
        --controls tf32,half_batch

One JSON line per seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def look(cell) -> dict:
    """Training: the leaves behind each leaf number, worst first, and the
    median leaf's gap; enhancement: the sampled files' gaps, worst first."""
    import statistics

    import numpy as np

    from port_bench.check import leaf_gaps

    ref, mine = cell._ref32, cell.mine
    if cell.traffic.kind != "train":
        rows = [[it["fs"], len(a), float(np.linalg.norm(a - b) / np.linalg.norm(b))]
                for it, a, b in zip(cell.ref_items, mine, ref)]
        return {"files": sorted(rows, key=lambda r: -r[2])[:4]}
    med = statistics.median(ref["grad"].values())
    moving = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}
    out = {}
    for key, keep in (("grad", None), ("change", moving), ("ema", moving)):
        if key in ref:
            gaps = leaf_gaps(mine[key], ref[key], keep)
            worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
            out[key] = {"worst": [[k, g, ref[key][k]] for k, g in worst],
                        "worst_gap": worst[0][1], "median_gap": statistics.median(gaps.values())}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", default="", help="comma-separated: tf32, fp8, half_batch")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--look", action="store_true",
                   help="training: the three worst leaves of each leaf number")
    args = p.parse_args(argv)
    import torch

    from port_bench.harness import Cell
    from port_bench.spec import Spec

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("port_bench: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec(Path.cwd())
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = Cell(spec, args.workload, seed, args.seconds, False, args.device, t0)
        out = cell.run()
        rec = {"seed": seed, "correct": out["correct"],
               "program": {k: v["value"] for k, v in out["checks"].items()},
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        for c in filter(None, args.controls.split(",")):
            rec[c] = cell.numbers(c)
        if args.look:
            rec["look"] = look(cell)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
