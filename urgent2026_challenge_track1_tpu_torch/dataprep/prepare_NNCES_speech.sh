#!/bin/bash
# Prepare the NNCES corpus: download, estimate effective bandwidth, and
# resample each file to the smallest standard rate covering it
# (the root utils/prepare_NNCES_speech.sh on the port's tools).
# Run from the repository root.
set -eu -o pipefail

output_dir="downloads/NNCES/"
mkdir -p "${output_dir}"

echo "=== Preparing NNCES data ==="
if [ ! -e "${output_dir}/download_NNCES.done" ]; then
    curl -L -o ${output_dir}/nonnative-children-english-speech-nnces-corpus.zip \
        https://www.kaggle.com/api/v1/datasets/download/kodaliradha20phd7093/nonnative-children-english-speech-nnces-corpus
    unzip ${output_dir}/nonnative-children-english-speech-nnces-corpus.zip -d ${output_dir}
    # normalize filenames (spaces/parentheses break scp tooling)
    find "${output_dir}" -type f | while read -r file; do
        dir=$(dirname "$file"); base=$(basename "$file")
        new_base=$(echo "$base" | sed 's/[ ()]/_/g')
        [ "$base" != "$new_base" ] && mv "$file" "$dir/$new_base" || true
    done
    touch "${output_dir}/download_NNCES.done"
fi

mkdir -p tmp
BW_EST_FILE=tmp/NNCES.json
if [ ! -f ${BW_EST_FILE} ]; then
    echo "[NNCES] estimating audio bandwidth"
    OMP_NUM_THREADS=1 python -m urgent2026_challenge_track1_tpu_torch.dataprep.estimate_audio_bandwidth \
        --audio_dir "${output_dir}/Read_Speech_Data" "${output_dir}/Spontaneous_Speech_Data" \
        --audio_format wav --chunksize 1000 --nj 8 \
        --outfile "${BW_EST_FILE}"
fi

RESAMP_SCP_FILE="${output_dir}/NNCES_resampled.scp"
if [ ! -f ${RESAMP_SCP_FILE} ]; then
    echo "[NNCES] resampling to estimated audio bandwidth"
    OMP_NUM_THREADS=1 python -m urgent2026_challenge_track1_tpu_torch.dataprep.resample_to_estimated_bandwidth \
        --bandwidth_data "${BW_EST_FILE}" \
        --out_scpfile "${RESAMP_SCP_FILE}" \
        --outdir "${output_dir}/resampled/" \
        --nj 8 --chunksize 1000
fi
