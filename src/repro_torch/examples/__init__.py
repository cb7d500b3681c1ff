"""Twins of ``examples/``: each runs on the card unless ``--device cpu``."""
