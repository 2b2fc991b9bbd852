"""Train steps of the port (``steps.py``)."""
