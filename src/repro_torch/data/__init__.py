"""Deterministic data generators (``synthetic.py``) and the host→device input
pipeline of the chunked loop (``pipeline.py``)."""
