#!/bin/bash
# Prepare the ESD corpus: download, estimate effective bandwidth, and
# resample each file to the smallest standard rate covering it
# (the root utils/prepare_ESD.sh on the port's tools).
# Run from the repository root.
set -eu -o pipefail

output_dir="downloads/ESD/"
mkdir -p "${output_dir}"

echo "=== Preparing ESD data ==="
###############################################################################
# The ESD database requires a signed license agreement from the National
# University of Singapore before use: https://hltsingapore.github.io/ESD/
# Set HAS_VALID_LICENSE=True only after obtaining the signed agreement.
###############################################################################
HAS_VALID_LICENSE=False  # CHANGE TO "True" IF LICENSED
if [ "$HAS_VALID_LICENSE" != "True" ]; then
    echo "ERROR: LICENSE REQUIRED for ESD — see script header"; exit 1
fi
if [ ! -e "${output_dir}/download_ESD.done" ]; then
    echo "Download the licensed ESD archive into ${output_dir} and unzip it"
    [ -d "${output_dir}/ESD" ] || exit 1
    touch "${output_dir}/download_ESD.done"
fi

mkdir -p tmp
BW_EST_FILE=tmp/ESD.json
if [ ! -f ${BW_EST_FILE} ]; then
    echo "[ESD] estimating audio bandwidth"
    OMP_NUM_THREADS=1 python -m urgent2026_challenge_track1_tpu_torch.dataprep.estimate_audio_bandwidth \
        --audio_dir "${output_dir}/ESD/" \
        --audio_format wav --chunksize 1000 --nj 8 \
        --outfile "${BW_EST_FILE}"
fi

RESAMP_SCP_FILE="${output_dir}/ESD_resampled.scp"
if [ ! -f ${RESAMP_SCP_FILE} ]; then
    echo "[ESD] resampling to estimated audio bandwidth"
    OMP_NUM_THREADS=1 python -m urgent2026_challenge_track1_tpu_torch.dataprep.resample_to_estimated_bandwidth \
        --bandwidth_data "${BW_EST_FILE}" \
        --out_scpfile "${RESAMP_SCP_FILE}" \
        --outdir "${output_dir}/resampled/" \
        --nj 8 --chunksize 1000
fi
