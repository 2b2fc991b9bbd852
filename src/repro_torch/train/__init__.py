"""Train steps (``steps.py``) and the chunked training loop (``loop.py``)."""
