"""Offline analysis of a trained quantizer (``analysis/codebook.py``)."""
