#!/bin/bash
# Enhance a scp with a trained checkpoint on the card (the root inference.sh
# on the port's inference CLI).  Run from the repository root:
#
#   bash urgent2026_challenge_track1_tpu_torch/dataprep/inference.sh [ckpt] [input_scp] [output_dir]
#
# ckpt is a checkpoint file or a trainer's checkpoints directory, whose
# newest step_<N>.pt is read; the default is the directory that training
# with conf/models/BSRNN_baseline.yaml writes.
set -eu -o pipefail

ckpt=${1:-exp/BSRNN_baseline/baseline/version_0/checkpoints}
input_scp=${2:-data/validation/wav.scp}
output_dir=${3:-enhanced/$(basename "${ckpt%.pt}")}

python -m urgent2026_challenge_track1_tpu_torch.inference \
    --input_scp "${input_scp}" \
    --ckpt_path "${ckpt}" \
    --output_dir "${output_dir}"
