#!/bin/bash
# Prepare the VocalSet corpus: download, estimate effective bandwidth, and
# resample each file to the smallest standard rate covering it
# (the root utils/prepare_VocalSet_speech.sh on the port's tools).
# Run from the repository root.
set -eu -o pipefail

output_dir="downloads/VocalSet/"
mkdir -p "${output_dir}"

echo "=== Preparing VocalSet data ==="
if [ ! -e "${output_dir}/download_VocalSet.done" ]; then
    curl -L -o ${output_dir}/VocalSet.zip \
        https://zenodo.org/records/1193957/files/VocalSet.zip?download=1
    unzip ${output_dir}/VocalSet.zip -d ${output_dir}
    touch "${output_dir}/download_VocalSet.done"
fi

mkdir -p tmp
BW_EST_FILE=tmp/VocalSet.json
if [ ! -f ${BW_EST_FILE} ]; then
    echo "[VocalSet] estimating audio bandwidth"
    OMP_NUM_THREADS=1 python -m urgent2026_challenge_track1_tpu_torch.dataprep.estimate_audio_bandwidth \
        --audio_dir "${output_dir}/FULL/" \
        --audio_format wav --chunksize 1000 --nj 8 \
        --outfile "${BW_EST_FILE}"
fi

RESAMP_SCP_FILE="${output_dir}/VocalSet_resampled.scp"
if [ ! -f ${RESAMP_SCP_FILE} ]; then
    echo "[VocalSet] resampling to estimated audio bandwidth"
    OMP_NUM_THREADS=1 python -m urgent2026_challenge_track1_tpu_torch.dataprep.resample_to_estimated_bandwidth \
        --bandwidth_data "${BW_EST_FILE}" \
        --out_scpfile "${RESAMP_SCP_FILE}" \
        --outdir "${output_dir}/resampled/" \
        --nj 8 --chunksize 1000
fi
