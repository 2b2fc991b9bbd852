"""Shared module conventions of the port (``Aux``)."""
