"""Training CLI of the port, with the flags of the JAX package's
``train_se.py``:

    python -m urgent2026_challenge_track1_tpu_torch.train_se \\
        --config_file conf/models/BSRNN_baseline.yaml [--key value ...]

Every Config default is a flag; the YAML overrides the flags; ``train_tag``
derives from the YAML's basename.  Resumes from the newest checkpoint under
``exp/{train_tag}/{train_name}/version_{train_version}/checkpoints``.
``--device`` is ``cuda`` (the default, which raises without a card) or
``cpu``.  PyYAML is needed only with ``--config_file``.

Data-parallel (and dp x mp) training runs one process a device under
``torchrun``, which this CLI reads from the environment (``WORLD_SIZE`` > 1):

    torchrun --nproc_per_node 8 -m urgent2026_challenge_track1_tpu_torch.train_se \
        --config_file conf/models/BSRNN_baseline.yaml --mesh_shape dp=-1

It initialises the process group (NCCL on the card, gloo with ``--device
cpu``) before it builds the trainer, as the JAX CLI calls
``jax.distributed.initialize()``.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from urgent2026_challenge_track1_tpu_torch import resolve_device
from urgent2026_challenge_track1_tpu_torch.config import Config, config_parser
from urgent2026_challenge_track1_tpu_torch.data.dataset import AudioDataModule
from urgent2026_challenge_track1_tpu_torch.train.trainer import Trainer, TrainState

__all__ = ["run", "main", "init_distributed"]


def init_distributed(device: str) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``WORLD_SIZE`` > 1, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for ``cuda``, each process on
    card ``LOCAL_RANK``, gloo for ``cpu``.  False (and nothing done) for a
    single process or a group already joined."""
    dist = torch.distributed
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def run(cfg: Config) -> TrainState:
    """Train from a Config (no YAML involved) and return the final state."""
    resolve_device(cfg.device)  # fail before reading any data
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    joined = init_distributed(cfg.device)
    try:
        return Trainer(cfg, AudioDataModule(cfg)).fit()
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def main(argv=None) -> TrainState:
    cfg = Config(**vars(config_parser(argv))).read_yaml()
    print(cfg)
    return run(cfg)


if __name__ == "__main__":
    main()
