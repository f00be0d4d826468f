"""The port's kernels: hand-written CUDA for sm_90a (``csrc/``), their
launchers (``kmeans.py``, ``quantize.py``, ``flash_attention.py``,
``decode_attention.py``), their plain PyTorch versions
(``ref.py``) and the public wrappers that pick between them (``ops.py``).
Nothing is built or loaded at import time (``build.py``)."""
