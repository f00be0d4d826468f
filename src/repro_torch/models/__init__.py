"""Models of the port: the paper's WRN (``wrn.py``)."""
