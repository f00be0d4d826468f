"""FLConfig: the paper's federated-split-training knobs.

A copy of ``repro.configs.base.FLConfig`` with the same field names and
defaults, so the two configs read alike. Two differences:

* ``use_pallas_selection`` and ``batched_selection`` are gone. In the port
  the device picks the engine (the hand-written CUDA kernels for tensors on
  ``cuda``, their plain PyTorch versions for tensors on the CPU), and the
  cohort runs client by client. ``select_per_cluster``,
  ``reset_upper_each_round`` and ``split_fraction`` are gone too: nothing
  reads them (the split point is ``WRNConfig.split_group``; the round
  takes one representative per cluster and meta-trains from W_G^u(0)).
  Passing any of these names is a ``TypeError``.
* ``distributed_selection``, ``selection_chunk_size``, ``pca_solver`` and
  ``observability`` are kept, but their engines are not ported yet: any
  value other than the default raises ``NotImplementedError``, so no knob
  is silently ignored.
"""
from __future__ import annotations

from dataclasses import dataclass

TRANSPORT_CODECS = ("raw_f32", "f16", "int8")


@dataclass(frozen=True)
class FLConfig:
    """The paper's knobs (Table 3/4/7 hyperparameters)."""
    num_clients: int = 20
    clients_per_round: int = 20
    local_epochs: int = 1
    local_batch_size: int = 50
    local_lr: float = 0.1
    # selection (Section 3.1)
    pca_components: int = 200
    clusters_per_class: int = 10
    kmeans_iters: int = 25
    # meta-training (Section 3.3)
    meta_epochs: int = 2
    meta_batch_size: int = 50
    meta_lr: float = 0.1
    meta_l2: float = 0.0               # Table 7: 0 / 5e-4 / 1e-3
    use_selection: bool = True         # False = Table 2 baseline (all maps)
    # --- engines not ported yet: only the defaults are accepted ---
    pca_solver: str = "exact"          # "randomized" waits for its port
    distributed_selection: bool = False
    selection_chunk_size: int = 0
    observability: bool = False
    # --- transport (repro_torch.fl.transport; exact frame bytes) ---
    transport_codec: str = "raw_f32"   # raw_f32 | f16 | int8
    transport_checksum: bool = False   # CRC32 trailer on every frame

    def __post_init__(self):
        not_ported = {"pca_solver": "exact", "distributed_selection": False,
                      "selection_chunk_size": 0, "observability": False}
        for name, default in not_ported.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"FLConfig.{name}={getattr(self, name)!r}: only "
                    f"{default!r} is ported to repro_torch so far")
        if self.transport_codec not in TRANSPORT_CODECS:
            raise ValueError(f"unknown transport codec "
                             f"{self.transport_codec!r} (have "
                             f"{list(TRANSPORT_CODECS)})")
