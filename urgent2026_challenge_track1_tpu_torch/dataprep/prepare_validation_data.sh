#!/bin/bash
# Assemble validation sources and simulate the validation set
# (the root utils/prepare_validation_data.sh on the port's tools).
# Run from the repository root.
set -eu -o pipefail

urgent25_path="${URGENT25_PATH:-/path/to/urgent2025_challenge}"
output_dir=./data/validation

mkdir -p ${output_dir} data/tmp/validation

cat ${urgent25_path}/data/tmp/*validation.text    > data/tmp/validation/all_text
cat ${urgent25_path}/data/tmp/*validation.utt2spk > data/tmp/validation/all_utt2spk
cat ${urgent25_path}/data/tmp/*validation.scp | \
    awk -v pwd="${urgent25_path}" '{ if ($3 !~ /^\//) { sub(/^\.\//, "", $3); $3 = pwd "/" $3 } print }' \
    > data/tmp/validation/all_scp

# meta/validation_selected is vendored in this repo (2,200 utterance ids,
# byte-identical to the reference's meta/validation_selected)
python utils/filter_scp.py meta/validation_selected < data/tmp/validation/all_text \
    > data/tmp/validation/speech_validation_subset.text
python utils/filter_scp.py meta/validation_selected < data/tmp/validation/all_utt2spk \
    > data/tmp/validation/speech_validation_subset.utt2spk
python utils/filter_scp.py meta/validation_selected < data/tmp/validation/all_scp \
    > data/tmp/validation/speech_validation_subset.scp

for pool in dns5_noise_resampled_validation wham_noise_validation fma_noise_resampled_validation fsd50k_noise_resampled_validation; do
    cat ${urgent25_path}/data/tmp/${pool}.scp
done | awk -v pwd="${urgent25_path}" '{ if ($3 !~ /^\//) { sub(/^\.\//, "", $3); $3 = pwd "/" $3 } print }' \
    > data/tmp/validation/noise_scoures.scp
awk -v pwd="${urgent25_path}" '{ if ($3 !~ /^\//) { sub(/^\.\//, "", $3); $3 = pwd "/" $3 } print }' \
    ${urgent25_path}/data/tmp/wind_noise_validation.scp > data/tmp/validation/wind_noise_scoures.scp
awk -v pwd="${urgent25_path}" '{ if ($3 !~ /^\//) { sub(/^\.\//, "", $3); $3 = pwd "/" $3 } print }' \
    ${urgent25_path}/data/tmp/dns5_rirs.scp > data/tmp/validation/rirs.scp

if [ ! -f "simulation_validation/log/meta.tsv" ]; then
    python -m urgent2026_challenge_track1_tpu_torch.simulation.generate_data_param \
        --config conf/simulation_validation.yaml
fi
OMP_NUM_THREADS=1 python -m urgent2026_challenge_track1_tpu_torch.simulation.simulate_data_from_param \
    --config conf/simulation_validation.yaml --nj 8 --chunksize 100 --highpass True

python -m urgent2026_challenge_track1_tpu_torch.dataprep.derive_data_dir \
    --meta_tsv simulation_validation/log/meta.tsv \
    --output_dir "${output_dir}"
