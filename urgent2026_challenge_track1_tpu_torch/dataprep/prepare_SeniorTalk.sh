#!/bin/bash
# Prepare the SeniorTalk corpus: download, estimate effective bandwidth, and
# resample each file to the smallest standard rate covering it
# (the root utils/prepare_SeniorTalk.sh on the port's tools).
# Run from the repository root.
set -eu -o pipefail

output_dir="downloads/SeniorTalk/"
mkdir -p "${output_dir}"

echo "=== Preparing SeniorTalk data ==="
# SeniorTalk is distributed via git-lfs (modelscope or huggingface mirror)
if [ ! -e "${output_dir}/download_SeniorTalk.done" ]; then
    command -v git-lfs >/dev/null || { echo "git-lfs required (https://git-lfs.com/)"; exit 1; }
    git clone https://www.modelscope.cn/datasets/BAAI/SeniorTalk.git ${output_dir}/SeniorTalk
    (cd ${output_dir}/SeniorTalk && git lfs pull)
    # unpack sentence-level audio tars
    find ${output_dir}/SeniorTalk -name "*.tar*" -exec tar -xf {} -C ${output_dir} \;
    touch "${output_dir}/download_SeniorTalk.done"
fi

mkdir -p tmp
BW_EST_FILE=tmp/SeniorTalk.json
if [ ! -f ${BW_EST_FILE} ]; then
    echo "[SeniorTalk] estimating audio bandwidth"
    OMP_NUM_THREADS=1 python -m urgent2026_challenge_track1_tpu_torch.dataprep.estimate_audio_bandwidth \
        --audio_dir "${output_dir}/sentence_data/wav/train" \
        --audio_format wav --chunksize 1000 --nj 8 \
        --outfile "${BW_EST_FILE}"
fi

RESAMP_SCP_FILE="${output_dir}/SeniorTalk_resampled.scp"
if [ ! -f ${RESAMP_SCP_FILE} ]; then
    echo "[SeniorTalk] resampling to estimated audio bandwidth"
    OMP_NUM_THREADS=1 python -m urgent2026_challenge_track1_tpu_torch.dataprep.resample_to_estimated_bandwidth \
        --bandwidth_data "${BW_EST_FILE}" \
        --out_scpfile "${RESAMP_SCP_FILE}" \
        --outdir "${output_dir}/resampled/" \
        --nj 8 --chunksize 1000
fi
