"""Models of the port: the paper's WRN (``wrn.py``) and the dense GQA
decoders of the LM serving path (``layers.py``, ``transformer.py``,
``registry.py``)."""
