#!/bin/bash
# Assemble training sources from a prepared urgent2025_challenge tree plus
# four extra corpora, then run the offline simulation and derive the
# training data directory (the root utils/prepare_train_data.sh on the
# port's tools).  Run from the repository root.
set -eu -o pipefail

dataprep=urgent2026_challenge_track1_tpu_torch/dataprep

# Path to an urgent2025_challenge checkout where prepare_espnet_data.sh ran.
urgent25_path="${URGENT25_PATH:-/path/to/urgent2025_challenge}"
train_source_output=./data/train_sources
train_simulation_output=./data/train_simulation

mkdir -p ${train_source_output} data/tmp/train_sources downloads

for corpus in NNCES SeniorTalk VocalSet ESD; do
    if [ ! -e "downloads/${corpus}.done" ]; then
        case ${corpus} in
            NNCES)      bash ${dataprep}/prepare_NNCES_speech.sh ;;
            SeniorTalk) bash ${dataprep}/prepare_SeniorTalk.sh ;;
            VocalSet)   bash ${dataprep}/prepare_VocalSet_speech.sh ;;
            ESD)        bash ${dataprep}/prepare_ESD.sh ;;
        esac
        cp downloads/${corpus}/${corpus}_resampled.scp data/tmp/train_sources/
        touch "downloads/${corpus}.done"
    fi
done

# URGENT-2025 training source subsets (paths made absolute)
subsets="dns5_clean_read_speech_resampled_filtered_train libritts_resampled_train \
vctk_train ears_train commonvoice_19.0_en_resampled_train_track1 \
commonvoice_19.0_de_resampled_train_track1 commonvoice_19.0_es_resampled_train_track1 \
commonvoice_19.0_fr_resampled_train_track1 commonvoice_19.0_zh-CN_resampled_train_track1 \
mls_german_resampled_train_track1 mls_spanish_resampled_train_track1 \
mls_french_resampled_train_track1"
for s in ${subsets}; do
    src="${urgent25_path}/data/tmp/${s}.scp"
    [ -f "${src}" ] || { echo "${src} not found — prepare URGENT25 data first"; exit 1; }
    awk -v pwd="${urgent25_path}" '{ if ($3 !~ /^\//) { sub(/^\.\//, "", $3); $3 = pwd "/" $3 } print }' \
        "${src}" > data/tmp/train_sources/$(basename ${src})
done
cat data/tmp/train_sources/*.scp > data/tmp/train_sources/all_scp

# challenge subset filter. NOTE: meta/train_urgent2026 is NOT shipped by the
# reference repo either (only meta/validation_selected is, vendored here);
# obtain it from the challenge kit and place it under meta/ before running.
python utils/filter_scp.py meta/train_urgent2026 < data/tmp/train_sources/all_scp \
    > ${train_source_output}/speech_sources.scp

awk '{print $1" "$1}' ${train_source_output}/speech_sources.scp > ${train_source_output}/utt2spk
awk '{print $1" "$1}' ${train_source_output}/speech_sources.scp > ${train_source_output}/spk2utt
touch ${train_source_output}/text

if [ ! -f "${train_source_output}/source_length.scp" ]; then
    python -m urgent2026_challenge_track1_tpu_torch.dataprep.utt2numsamples \
        --input_scp ${train_source_output}/speech_sources.scp \
        --outfile ${train_source_output}/source_length.scp
fi

for pool in dns5_noise_resampled_train wham_noise_train fma_noise_resampled_train fsd50k_noise_resampled_train; do
    cat ${urgent25_path}/data/tmp/${pool}.scp
done | awk -v pwd="${urgent25_path}" '{ if ($3 !~ /^\//) { sub(/^\.\//, "", $3); $3 = pwd "/" $3 } print }' \
    > ${train_source_output}/noise_scoures.scp
awk -v pwd="${urgent25_path}" '{ if ($3 !~ /^\//) { sub(/^\.\//, "", $3); $3 = pwd "/" $3 } print }' \
    ${urgent25_path}/data/tmp/wind_noise_train.scp > ${train_source_output}/wind_noise_scoures.scp
awk -v pwd="${urgent25_path}" '{ if ($3 !~ /^\//) { sub(/^\.\//, "", $3); $3 = pwd "/" $3 } print }' \
    ${urgent25_path}/data/tmp/dns5_rirs.scp > ${train_source_output}/rirs.scp

# offline simulation (phase 1: parameters; phase 2: rendering, ~30 min @ nj=8)
if [ ! -f "simulation_train/log/meta.tsv" ]; then
    python -m urgent2026_challenge_track1_tpu_torch.simulation.generate_data_param \
        --config conf/simulation_train.yaml
fi
OMP_NUM_THREADS=1 python -m urgent2026_challenge_track1_tpu_torch.simulation.simulate_data_from_param \
    --config conf/simulation_train.yaml --nj 8 --chunksize 100 --highpass True

python -m urgent2026_challenge_track1_tpu_torch.dataprep.derive_data_dir \
    --meta_tsv simulation_train/log/meta.tsv \
    --output_dir "${train_simulation_output}"
