"""Reference-free parity harnesses: the twin configuration and corpus
(``twin.py``) and the exact-vs-lattice CRF comparison
(``crf_compare.py``)."""
