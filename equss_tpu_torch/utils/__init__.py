"""Host-side utilities: the prediction and codeword PNGs (``visualize.py``)."""
