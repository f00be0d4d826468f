"""Configs of the port: the WRN of the paper and the FL knobs."""
from repro_torch.configs.base import FLConfig
from repro_torch.configs.wrn_cifar import CONFIG as WRN_CONFIG, WRNConfig


def get_wrn_config() -> WRNConfig:
    """The paper's WRN-40-1 (``.reduced()`` gives the WRN-10-1 test size)."""
    return WRN_CONFIG


__all__ = ["FLConfig", "WRNConfig", "WRN_CONFIG", "get_wrn_config"]
