"""Models of the port: the paper's WRN (``wrn.py``) and the GQA decoders
of the LM path, dense or MoE (``layers.py``, ``transformer.py``,
``registry.py``)."""
from repro_torch.models.registry import (count_params, make_lm,
                                         make_split_model)

__all__ = ["count_params", "make_lm", "make_split_model"]
