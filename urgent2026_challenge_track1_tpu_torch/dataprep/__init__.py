"""Data preparation on the host (counterparts of the root ``utils/`` tools):
``estimate_audio_bandwidth`` (each file's effective bandwidth),
``resample_to_estimated_bandwidth`` (each file to the smallest standard
rate that holds it), ``utt2numsamples``, ``extract_random_subset`` and
``derive_data_dir`` (a Kaldi-style directory from a simulation meta.tsv),
each a ``python -m urgent2026_challenge_track1_tpu_torch.dataprep.<tool>``
with the root tool's flags and output, and the shell scripts that build the
training and validation corpora with them (``prepare_*.sh``) and enhance a
scp (``inference.sh``).  Host numpy, as in the JAX package: nothing here
runs on the card."""
