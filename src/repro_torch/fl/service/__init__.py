"""repro_torch.fl.service — the event-driven FL server of the port (the
counterpart of ``repro.fl.service``).

``FLSimulation`` is a synchronous for-loop over rounds; this package runs
the same split-FL math as a continuously ticking service: seeded traffic
models produce client arrivals (``traffic``, copied from the reference:
the same schedules), each arrival replays the client pipeline over the
wire format, and a FedBuff-style buffered aggregator (``aggregator``)
applies staleness-weighted WeightAverage once ``buffer_size`` updates
accumulate. The synchronous simulator remains the bit-exact oracle for the
degenerate configuration — see tests/test_torch_service.py.
"""
from repro_torch.fl.service.aggregator import (BufferedAggregator,
                                               BufferEntry, staleness_weight)
from repro_torch.fl.service.loop import FLService, ServiceResult
from repro_torch.fl.service.traffic import (Arrival, DegenerateTraffic,
                                            DiurnalTraffic, PoissonTraffic,
                                            TrafficModel)

__all__ = [
    "Arrival", "BufferEntry", "BufferedAggregator", "DegenerateTraffic",
    "DiurnalTraffic", "FLService", "PoissonTraffic", "ServiceResult",
    "TrafficModel", "staleness_weight",
]
