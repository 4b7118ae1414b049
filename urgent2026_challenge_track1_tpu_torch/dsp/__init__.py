"""STFT front end (counterpart of ``urgent2026_challenge_track1_tpu.dsp``)."""
