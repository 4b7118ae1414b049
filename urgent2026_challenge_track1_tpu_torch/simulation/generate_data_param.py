"""Offline simulation, phase 1: draw a recipe per utterance into meta.tsv
(counterpart of ``simulation/generate_data_param.py``).

    python -m urgent2026_challenge_track1_tpu_torch.simulation.generate_data_param \
        --config conf/simulation_train.yaml --speech_scps ... --log_dir ... \
        --output_dir ...

The JAX CLI's flags (``--config`` YAML gives defaults), its meta.tsv columns,
its output paths (5000 files a subdirectory) and its order of draws under
``--seed``.  The draws come from one ``np.random.RandomState(--seed)``
handed to ``params.sample_meta``: a RandomState seeded with s yields the
stream of ``np.random.seed(s)``, so a seed writes the JAX CLI's meta.tsv
byte for byte.  Nothing on this path draws from Python's ``random``.
PyYAML is imported where a YAML value is parsed, not with the module.
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np

from urgent2026_challenge_track1_tpu_torch.simulation.params import sample_meta
from urgent2026_challenge_track1_tpu_torch.utils import audio_io

__all__ = ["ConfigArgumentParser", "cli", "get_parser", "main"]


def _read_three_col(scps):
    dic = defaultdict(dict)
    for scp in scps:
        with open(scp, "r") as f:
            for line in f:
                uid, fs, audio_path = line.strip().split()
                if uid in dic[int(fs)]:
                    raise ValueError(f"{scp}: duplicate uid {uid} at {fs} Hz")
                dic[int(fs)][uid] = audio_path
    return dic


def _read_two_col(paths, split):
    dic = {}
    for path in paths or []:
        with open(path, "r") as f:
            for line in f:
                uid, value = split(line)
                if uid in dic:
                    raise ValueError(f"{path}: duplicate uid {uid}")
                dic[uid] = value
    return dic


def main(args, rng: np.random.RandomState | None = None):
    """Write ``<log_dir>/meta.tsv``; every draw from ``rng``, by default
    ``np.random.RandomState(args.seed)``."""
    rng = np.random.RandomState(args.seed) if rng is None else rng
    speech_dic = _read_three_col(args.speech_scps)
    utt2spk = _read_two_col(args.speech_utt2spk, lambda line: line.strip().split())
    text = _read_two_col(args.speech_text, lambda line: line.strip().split(maxsplit=1))

    noise_dic = _read_three_col(args.noise_scps)
    used_noise_dic = {fs: {} for fs in noise_dic.keys()}
    wind_noise_dic = _read_three_col(args.wind_noise_scps or [])
    used_wind_noise_dic = {fs: {} for fs in wind_noise_dic.keys()}

    rir_dic = None
    if args.rir_scps is not None and args.prob_reverberation > 0.0:
        rir_dic = _read_three_col(args.rir_scps)
    used_rir_dic = {fs: {} for fs in rir_dic.keys()} if rir_dic is not None else None

    Path(args.log_dir).mkdir(parents=True, exist_ok=True)
    headers = ["id", "noisy_path", "speech_uid", "speech_sid", "clean_path", "noise_uid"]
    if args.store_noise:
        headers.append("noise_path")
    headers += ["snr_dB", "rir_uid", "augmentation", "fs", "length", "text"]

    outdir = Path(args.output_dir)
    snr_range = (args.snr_low_bound, args.snr_high_bound)
    wind_noise_snr_range = (args.wind_noise_snr_low_bound, args.wind_noise_snr_high_bound)

    augmentations = list(args.augmentations.keys())
    weight_augmentations = np.array([v["weight"] for v in args.augmentations.values()])
    weight_augmentations = weight_augmentations / np.sum(weight_augmentations)

    try:
        from tqdm import tqdm
    except ImportError:
        tqdm = lambda x: x  # noqa: E731

    count = 0
    with open(Path(args.log_dir) / "meta.tsv", "w") as f:
        f.write("\t".join(headers) + "\n")
        for fs in sorted(speech_dic.keys(), reverse=True):
            for uid, audio_path in tqdm(speech_dic[fs].items()):
                sid = utt2spk.get(uid, "<unk>")
                transcript = text.get(uid, "<not-available>")
                speech_length = audio_io.info_frames(audio_path)

                for _ in range(args.repeat_per_utt):
                    use_wind_noise = rng.random() < args.prob_wind_noise
                    num_aug = rng.choice(
                        list(args.num_augmentations.keys()),
                        p=list(args.num_augmentations.values()),
                    )
                    if num_aug == 0:
                        aug = "none"
                    else:
                        aug = rng.choice(
                            augmentations, p=weight_augmentations, size=num_aug, replace=False
                        )
                        while use_wind_noise and "clipping" in aug:
                            aug = rng.choice(
                                augmentations, p=weight_augmentations,
                                size=num_aug, replace=False,
                            )

                    info = sample_meta(
                        args,
                        speech_length,
                        fs,
                        noise_dic=noise_dic,
                        used_noise_dic=used_noise_dic,
                        wind_noise_dic=wind_noise_dic,
                        used_wind_noise_dic=used_wind_noise_dic,
                        use_wind_noise=use_wind_noise,
                        snr_range=snr_range,
                        wind_noise_snr_range=wind_noise_snr_range,
                        store_noise=args.store_noise,
                        rir_dic=rir_dic,
                        used_rir_dic=used_rir_dic,
                        augmentations=aug,
                        force_1ch=True,
                        rng=rng,
                    )
                    count += 1
                    filedir = str(count // 5000)
                    (outdir / "noisy" / filedir).mkdir(parents=True, exist_ok=True)
                    (outdir / "clean" / filedir).mkdir(parents=True, exist_ok=True)
                    filename = f"fileid_{count}.{args.out_format}"
                    lst = [
                        f"fileid_{count}",
                        str(outdir / "noisy" / filedir / filename),
                        uid,
                        sid,
                        str(outdir / "clean" / filedir / filename),
                        info["noise_uid"],
                    ]
                    if args.store_noise:
                        (outdir / "noise" / filedir).mkdir(parents=True, exist_ok=True)
                        lst.append(str(outdir / "noise" / filedir / filename))
                    lst += [
                        str(info["snr"]),
                        info["rir_uid"],
                        info["augmentation"],
                        str(info["fs"]),
                        str(info["length"]),
                        transcript,
                    ]
                    f.write("\t".join(lst) + "\n")


def _str2bool(v):
    return str(v).lower() in ("yes", "true", "t", "y", "1")


def _yaml_value(text):
    import yaml

    return yaml.safe_load(text)


class ConfigArgumentParser(argparse.ArgumentParser):
    """argparse with ``--config yaml`` providing the defaults (espnet's
    config_argparse)."""

    def parse_args(self, argv=None, namespace=None):
        base = argparse.ArgumentParser(add_help=False)
        base.add_argument("--config", type=str, default=None)
        cfg_args, remaining = base.parse_known_args(argv)
        if cfg_args.config is not None:
            with open(cfg_args.config, "r") as f:
                defaults = _yaml_value(f)
            self.set_defaults(**defaults)
        ns = super().parse_args(remaining, namespace)
        ns.config = cfg_args.config
        return ns


def get_parser(parser=None):
    if parser is None:
        parser = ConfigArgumentParser(description="simulation parameter generation")
    g = parser.add_argument_group(description="General arguments")
    g.add_argument("--speech_scps", type=str, nargs="+")
    g.add_argument("--speech_utt2spk", type=str, nargs="+", default=None)
    g.add_argument("--speech_text", type=str, nargs="+", default=None)
    g.add_argument("--log_dir", type=str)
    g.add_argument("--output_dir", type=str)
    g.add_argument("--out_format", type=str, default="flac",
                   help="output audio format (FLAC through utils/flac.py)")
    g.add_argument("--repeat_per_utt", type=int, default=1)
    g.add_argument("--seed", type=int, default=0)
    g = parser.add_argument_group(description="Additive noise related")
    g.add_argument("--noise_scps", type=str, nargs="+")
    g.add_argument("--snr_low_bound", type=float, default=-5.0)
    g.add_argument("--snr_high_bound", type=float, default=20.0)
    g.add_argument("--reuse_noise", type=_str2bool, default=False)
    g.add_argument("--store_noise", type=_str2bool, default=False)
    g = parser.add_argument_group(description="Wind-noise related")
    g.add_argument("--wind_noise_scps", type=str, nargs="+", default=None)
    g.add_argument("--prob_wind_noise", type=float, default=0.05)
    g.add_argument("--wind_noise_config", type=_yaml_value, default={})
    g.add_argument("--reuse_wind_noise", type=_str2bool, default=False)
    g.add_argument("--wind_noise_snr_low_bound", type=float, default=-5.0)
    g.add_argument("--wind_noise_snr_high_bound", type=float, default=20.0)
    g = parser.add_argument_group(description="Reverberation related")
    g.add_argument("--rir_scps", type=str, nargs="+", default=None)
    g.add_argument("--prob_reverberation", type=float, default=0.5)
    g.add_argument("--reuse_rir", type=_str2bool, default=False)
    g = parser.add_argument_group(description="Additional augmentation related")
    g.add_argument("--augmentations", type=_yaml_value,
                   default=dict(none=dict(weight=1.0)))
    g.add_argument("--num_augmentations", type=_yaml_value, default=dict())
    return parser


def cli(argv=None):
    """Parse, check the required paths, create the output directories and
    run ``main`` under ``--seed``."""
    args = get_parser().parse_args(argv)
    print(args)
    if not (args.speech_scps and args.log_dir and args.output_dir and args.noise_scps):
        raise SystemExit("--speech_scps, --log_dir, --output_dir and --noise_scps are required")
    if args.prob_reverberation > 0 and not args.rir_scps:
        raise SystemExit("--rir_scps is required when --prob_reverberation > 0")

    outdir = Path(args.output_dir)
    (outdir / "clean").mkdir(parents=True, exist_ok=True)
    (outdir / "noisy").mkdir(parents=True, exist_ok=True)
    if args.store_noise:
        (outdir / "noise").mkdir(parents=True, exist_ok=True)
    Path(args.log_dir).mkdir(parents=True, exist_ok=True)
    main(args)


if __name__ == "__main__":
    cli()
