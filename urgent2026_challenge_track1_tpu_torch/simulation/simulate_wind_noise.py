"""Wind-noise corpus generator (counterpart of ``simulation/simulate_wind_noise.py``).

    python -m urgent2026_challenge_track1_tpu_torch.simulation.simulate_wind_noise \
        --output_dir data/wind_noise --config conf/wind_noise_simulation_train.yaml

For each sampling rate of the config, with its seed, writes ``num_data``
files ``wind_noise_{fs}hz/wind_noise_{i}.wav`` and one ``wind_noise.scp``
line ``uid fs abs_path`` per file.  Refuses an output directory that exists.

The draws follow the JAX CLI's: item i's gustiness is drawn *before* its
generator seeds the state with ``seed + i``, so it comes from the state
that generator i - 1 left (item 0: from the state the process started
with).  One ``np.random.RandomState`` carries that state here; ``main``
takes it as ``rng`` (not a CLI flag), so a caller can replay a run whose
global state it seeded.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from urgent2026_challenge_track1_tpu_torch.simulation.wind import WindNoiseGenerator
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = ["main"]


def main(argv=None, *, rng: np.random.RandomState | None = None):
    import yaml

    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=Path, required=True)
    parser.add_argument("--config", type=Path, required=True)
    args = parser.parse_args(argv)

    with open(args.config, "r") as yml:
        config = yaml.safe_load(yml)
    print(config)

    if os.path.exists(args.output_dir):
        raise RuntimeError(
            f"{args.output_dir} already exists. Please delete it to run again."
        )
    args.output_dir.mkdir(parents=True)
    rng = np.random.RandomState() if rng is None else rng

    try:
        from tqdm import tqdm
    except ImportError:
        tqdm = lambda x: x  # noqa: E731

    with open(args.output_dir / "wind_noise.scp", "w") as scp:
        for seed, sample_rate in zip(config["seeds"], config["sample_rates"]):
            output_dir = args.output_dir / f"wind_noise_{sample_rate}hz"
            output_dir.mkdir(parents=True)
            for i in tqdm(range(config["num_data"])):
                gustiness = rng.uniform(*config["gustiness_range"])
                wn = WindNoiseGenerator(
                    fs=sample_rate,
                    duration=config["duration"],
                    generate=True,
                    gustiness=gustiness,
                    start_seed=seed + i,
                    rng=rng,
                )
                wn_signal, _ = wn.generate_wind_noise()
                output_path = output_dir / f"wind_noise_{i}.wav"
                audio_io.write(str(output_path), wn_signal, sample_rate)
                scp.write(
                    f"wind_noise_{sample_rate}hz_{i} {sample_rate} "
                    f"{output_path.resolve()}\n"
                )


if __name__ == "__main__":
    main()
