"""Deterministic data generators of the port (``synthetic.py``)."""
