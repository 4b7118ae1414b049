"""Simulation engine on the host: ``params.sample_meta`` draws a recipe
(pure metadata, the reference's meta.tsv strings) and ``render.render_one``
turns it into audio, for the dynamic-mixing dataset (``data/dynamic.py``)."""
