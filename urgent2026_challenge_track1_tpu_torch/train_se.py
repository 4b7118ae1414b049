"""Training CLI of the port, with the flags of the JAX package's
``train_se.py``:

    python -m urgent2026_challenge_track1_tpu_torch.train_se \\
        --config_file conf/models/BSRNN_baseline.yaml [--key value ...]

Every Config default is a flag; the YAML overrides the flags; ``train_tag``
derives from the YAML's basename.  Resumes from the newest checkpoint under
``exp/{train_tag}/{train_name}/version_{train_version}/checkpoints``.
``--device`` is ``cuda`` (the default, which raises without a card) or
``cpu``.  PyYAML is needed only with ``--config_file``.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from urgent2026_challenge_track1_tpu_torch import resolve_device
from urgent2026_challenge_track1_tpu_torch.config import Config, config_parser
from urgent2026_challenge_track1_tpu_torch.data.dataset import AudioDataModule
from urgent2026_challenge_track1_tpu_torch.train.trainer import Trainer, TrainState

__all__ = ["run", "main"]


def run(cfg: Config) -> TrainState:
    """Train from a Config (no YAML involved) and return the final state."""
    resolve_device(cfg.device)  # fail before reading any data
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    return Trainer(cfg, AudioDataModule(cfg)).fit()


def main(argv=None) -> TrainState:
    cfg = Config(**vars(config_parser(argv))).read_yaml()
    print(cfg)
    return run(cfg)


if __name__ == "__main__":
    main()
