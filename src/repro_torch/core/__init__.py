"""Quantizers, LUT layers, truth tables, the DAIS IR, lowering and analysis."""
