"""Offline simulation, phase 2: render meta.tsv into paired clean/noisy
corpora (counterpart of ``simulation/simulate_data_from_param.py``).

    python -m urgent2026_challenge_track1_tpu_torch.simulation.simulate_data_from_param \
        --config conf/simulation_train.yaml --log_dir ... [phase 1's flags] \
        [--nj 8] [--highpass True]

Reads the meta.tsv of phase 1 from ``--log_dir`` (``--meta_tsv`` when no
``--log_dir`` is given) and renders each row with ``render.render_one``,
which seeds its generator from the file id, over a ``spawn`` pool of
``capped_nj(--nj)`` workers (in this process at one).  Host numpy, as in
the JAX package: a row's files are the JAX CLI's bit for bit.
"""

from __future__ import annotations

import multiprocessing as mp
from functools import partial
from pathlib import Path

from urgent2026_challenge_track1_tpu_torch.simulation.generate_data_param import (
    _str2bool,
    get_parser,
)
from urgent2026_challenge_track1_tpu_torch.simulation.render import render_one
from urgent2026_challenge_track1_tpu_torch.utils import capped_nj

__all__ = ["main", "parser"]


def _read_flat_scp(scps):
    dic = {}
    for scp in scps:
        with open(scp, "r") as f:
            for line in f:
                uid, fs, audio_path = line.strip().split()
                if uid in dic:
                    raise ValueError(f"{scp}: duplicate uid {uid}")
                dic[uid] = audio_path
    return dic


def main(args):
    speech_dic = _read_flat_scp(args.speech_scps)
    noise_dic = _read_flat_scp(args.noise_scps)
    noise_dic.update(_read_flat_scp(args.wind_noise_scps or []))
    rir_dic = _read_flat_scp(args.rir_scps) if args.rir_scps is not None else None

    meta_path = (
        Path(args.log_dir) / "meta.tsv" if args.log_dir is not None else Path(args.meta_tsv)
    )
    meta = []
    with open(meta_path, "r") as f:
        headers = next(f).strip().split("\t")
        for line in f:
            meta.append(dict(zip(headers, line.strip().split("\t"))))

    worker = partial(
        render_one,
        store_noise=args.store_noise,
        speech_dic=speech_dic,
        noise_dic=noise_dic,
        rir_dic=rir_dic,
        highpass=args.highpass,
    )
    nj = capped_nj(args.nj)
    if nj <= 1:
        try:
            from tqdm import tqdm
        except ImportError:
            tqdm = lambda x: x  # noqa: E731
        for m in tqdm(meta):
            worker(m)
    else:
        with mp.get_context("spawn").Pool(nj) as pool:
            for i, _ in enumerate(pool.imap_unordered(worker, meta, chunksize=args.chunksize)):
                if i % 500 == 0:
                    print(f"rendered {i}/{len(meta)}", flush=True)


def parser():
    """Phase 1's parser with this phase's flags."""
    p = get_parser()
    g = p.add_argument_group(description="New arguments")
    g.add_argument("--meta_tsv", type=str, default=None,
                   help="meta.tsv to render when no --log_dir is given")
    g.add_argument("--nj", type=int, default=8)
    g.add_argument("--chunksize", type=int, default=1000)
    # '--highpass False' means False (argparse's type=bool would read it as True)
    g.add_argument("--highpass", type=_str2bool, default=False)
    return p


if __name__ == "__main__":
    args = parser().parse_args()
    print(args)
    main(args)
