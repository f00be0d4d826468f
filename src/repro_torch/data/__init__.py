from repro_torch.data.datasets import (Dataset, SyntheticActivationMaps,
                                      SyntheticImageDataset,
                                      SyntheticTokenDataset)
from repro_torch.data.partition import (ClientData, partition_dirichlet,
                                       partition_k_shards)
from repro_torch.data.pipeline import BatchIterator, batched_epoch

__all__ = ["BatchIterator", "ClientData", "Dataset",
           "SyntheticActivationMaps", "SyntheticImageDataset",
           "SyntheticTokenDataset", "batched_epoch", "partition_dirichlet",
           "partition_k_shards"]
