"""Federated roles and the simulation harness of the port."""
from repro_torch.fl.comms import CommLedger

__all__ = ["CommLedger"]
