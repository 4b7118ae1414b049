"""Run one cell of the port's benchmark on this machine's card.

    python3 port_bench/run.py --workload bsrnn196.train --seed 7 --seconds 30 --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port ``urgent2026_challenge_track1_tpu_torch``.  Prints one JSON
object as the last line of standard output (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics, the device's busy
time and a breakdown), and each number compared with the reference beside
its limit as the last lines of standard error.  Exits non-zero without a
result when there is no card, too few cards, no port beside it, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")  # keep transformers, if anything loads it, off JAX
os.environ.setdefault("USE_JAX", "0")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "urgent2026_challenge_track1_tpu_torch" / "__init__.py").exists():
        print("port_bench: the port urgent2026_challenge_track1_tpu_torch is not beside "
              "this folder", file=sys.stderr)
        return 2
    import torch

    from port_bench.harness import Cell
    from port_bench.spec import Spec

    spec = Spec(Path.cwd())
    chips = int(spec.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    out = Cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
               T_START).run()
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
