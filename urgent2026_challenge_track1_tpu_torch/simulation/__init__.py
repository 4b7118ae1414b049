"""Simulation engine on the host: ``params.sample_meta`` draws a recipe
(pure metadata, the reference's meta.tsv strings) and ``render.render_one``
turns it into audio, for the dynamic-mixing dataset (``data/dynamic.py``)
and the offline CLIs: ``generate_data_param`` (recipes -> meta.tsv),
``simulate_data_from_param`` (meta.tsv -> corpora) and
``simulate_wind_noise`` (``wind.WindNoiseGenerator`` -> a wind-noise
corpus)."""
