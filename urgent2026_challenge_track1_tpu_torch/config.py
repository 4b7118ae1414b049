"""Config system: defaults-as-schema attribute bag with YAML and CLI
override (counterpart of ``config.py``).

``Config(**kwargs)``, ``cfg.read_yaml()`` and ``config_parser()``, which
generates one ``--key value`` flag per default.  The schema keeps every key
of the JAX package's, so its YAML files load here (``model_configs`` may
carry ``causal`` and ``streaming_norm``).  ``mesh_shape`` places the
trainer on a dp x mp mesh of processes (``parallel/mesh.py``).  ``device``
is ``cuda`` (the default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

__all__ = ["Config", "config_parser", "DEVICES"]

DEVICES = ("cuda", "cpu")


class Config:
    """Flat attribute bag; the defaults below define the schema."""

    def __init__(self, **kwargs):
        # --- optimization ---
        self.learning_rate = 1e-3
        self.batch_size = 2
        self.weight_decay = 1e-6
        self.adam_epsilon = 1e-8
        self.num_worker = 4
        self.num_train_epochs = 150
        self.device = "cuda"          # "cuda" | "cpu"
        self.num_gpu = 1              # kept for signature parity
        self.train_version = 0
        self.train_tag = "run_0"
        self.train_name = "baseline"
        self.val_check_interval = 50000
        self.save_top_k = 3
        self.checkpoint_metric = "val_loss"  # top-k key
        self.checkpoint_mode = None   # None: "max" for an SI-SNR metric,
        #                               else "min" (the JAX package's rule);
        #                               "min" | "max" overrides it
        self.save_last = True         # keep a "latest" ckpt for resume
        self.resume = True
        self.seed = 1996
        self.gradient_clip = 0.5
        self.lr_step_size = 1
        self.lr_gamma = 0.85
        # --- data ---
        self.train_set_path = "none"
        self.train_set_dynamic_mixing = True
        self.dynamic_mixing_on_device = False
        self.valid_set_path = "none"
        self.init_from = "none"
        self.max_duration = 96000
        self.use_high_pass = True
        # --- model selection ---
        self.se_model = "bsrnn"
        self.model_type = "discriminative"  # "discriminative" | "flowse"
        self.config_file = "none"
        self.model_configs = None
        # --- flow matching ---
        self.ema_decay = 0.999
        self.theta = 1.5
        self.sigma_max = 0.5
        self.sigma_min = 0.05
        self.t_eps = 0.03
        self.T_rev = 1.0
        self.loss_type = "mse"
        self.loss_abs_exponent = 0.5
        self.n_fft = 1536
        self.hop_length = 384
        self.spec_transform_type = "exponent"
        self.spec_abs_exponent = 0.667
        self.spec_factor = 0.065
        self.bsrnn_hidden = 384
        self.num_layer = 6
        # --- keys of the JAX package's runtime ---
        self.mesh_shape = "dp=-1"     # "dp=-1" (every process), "dp=2,mp=4"
        self.compute_dtype = "float32"  # "float32" | "bfloat16" matmul inputs
        self.length_bucket_ms = 1000  # pad batches up to multiples of this
        self.log_every_steps = 50
        self.runahead_sync_steps = 4  # read by the JAX trainer only
        self.profile_start_step = -1  # a torch.profiler trace window (-1 = off)
        self.profile_num_steps = 5
        self.use_pallas_lstm = "auto"  # read by the JAX trainer only: the port
        #                                always runs its kernels on the card

        self._schema_keys = frozenset(k for k in vars(self) if not k.startswith("_"))
        for k, v in kwargs.items():
            setattr(self, k, v)

    def read_yaml(self):
        """YAML override; sets train_tag from the YAML basename.  Unknown keys
        raise.  ``device: tpu`` (the JAX package's accelerator, as its YAML
        files say) leaves the device to the command line; any other value
        than cuda or cpu raises."""
        if self.config_file != "none":
            import yaml  # only here: the port runs without PyYAML otherwise

            with open(self.config_file, "r", encoding="utf-8") as f:
                d = yaml.safe_load(f.read())
            unknown = sorted(set(d) - self._schema_keys)
            if unknown:
                raise ValueError(
                    f"unknown config key(s) in {self.config_file}: {unknown}; "
                    "valid keys are the Config schema attributes"
                )
            if d.get("device") == "tpu":
                d = {k: v for k, v in d.items() if k != "device"}
            if "device" in d and d["device"] not in DEVICES:
                raise ValueError(f"device {d['device']!r} in {self.config_file}: "
                                 f"expected one of {DEVICES}")
            for k, v in d.items():
                setattr(self, k, v)
            self.train_tag = os.path.basename(self.config_file).replace(".yaml", "")
        return self

    def to_dict(self) -> dict:
        """Public schema fields only (JSON-serializable config snapshot)."""
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}

    def __repr__(self):
        body = ",\n  ".join(
            f"{k}={v!r}" for k, v in sorted(vars(self).items()) if not k.startswith("_")
        )
        return f"Config(\n  {body}\n)"


def _str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def config_parser(argv=None):
    """One CLI flag per Config default; ``--model_configs`` takes JSON."""
    cfg = Config()
    parameters = {k: v for k, v in vars(cfg).items() if not k.startswith("_")}
    parser = argparse.ArgumentParser()
    for par, default in parameters.items():
        if isinstance(default, bool):
            typ = _str2bool
        elif par == "model_configs":
            typ = json.loads  # e.g. '{"num_channel": 8, "num_layer": 2}'
        elif default is None:
            typ = str
        else:
            typ = type(default)
        choices = DEVICES if par == "device" else None
        parser.add_argument(f"--{par}", type=typ, default=default, choices=choices)
    return parser.parse_args(argv)
