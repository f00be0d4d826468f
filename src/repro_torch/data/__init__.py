from repro_torch.data.datasets import (Dataset, SyntheticActivationMaps,
                                      SyntheticImageDataset,
                                      SyntheticTokenDataset)
from repro_torch.data.partition import (ClientData, partition_dirichlet,
                                       partition_k_shards)

__all__ = ["Dataset", "SyntheticActivationMaps", "SyntheticImageDataset",
           "SyntheticTokenDataset", "partition_k_shards",
           "partition_dirichlet", "ClientData"]
