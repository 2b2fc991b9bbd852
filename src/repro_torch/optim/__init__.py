"""Optimizers of the port (``adam.py``)."""
