"""Config system of the port: ModelConfig (LM architecture), ShapeConfig
and INPUT_SHAPES (input shapes), FLConfig (the paper's federated-split-
training knobs).

``ModelConfig``, ``ShapeConfig``, ``INPUT_SHAPES``, ``VOCAB_PAD`` and
``pad_to`` are copies of ``repro.configs.base``'s, with the same names,
fields and defaults (``num_params`` counts the port's own parameters).

``FLConfig`` is a copy of ``repro.configs.base.FLConfig`` with the same
field names and defaults, so the two configs read alike. Two differences:

* ``use_pallas_selection`` and ``batched_selection`` are gone. In the port
  the device picks the engine (the hand-written CUDA kernels for tensors on
  ``cuda``, their plain PyTorch versions for tensors on the CPU), and
  selection runs client by client in every engine. ``select_per_cluster``,
  ``reset_upper_each_round`` and ``split_fraction`` are gone too: nothing
  reads them (the split point is ``WRNConfig.split_group``; the round
  takes one representative per cluster and meta-trains from W_G^u(0)).
  Passing any of these names is a ``TypeError``.
* ``distributed_selection`` routes the cohort through the cohort engine
  (``core/distributed.py``, one device). ``selection_chunk_size`` is
  accepted, as in the reference, and changes nothing: it bounds how many
  clients' activation maps the reference's batched forward holds at once,
  and every engine of the port already selects one client at a time.
* ``pca_solver`` is "exact" (the Gram matrix's eigh, the default) or
  "randomized" (the range finder, ``core/selection.py``); any other value
  raises ``ValueError``. ``observability`` is ported (``repro_torch.obs``:
  the tracer, metrics and the ledger bridge).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

VOCAB_PAD = 256  # Megatron-style vocab padding so the vocab dim shards cleanly.


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned architecture.

    ``layer_kinds`` describes the repeating block pattern:
      - dense / moe LMs:     ("attn",) * L                     (scan, homogeneous)
      - rwkv6:               ("rwkv",) * L
      - jamba superblock:    ("mamba",)*7 + ("attn",)  x (L//8) (scan over superblocks)
    Gemma3's 5-local:1-global pattern is data, not structure: the per-layer
    sliding window size rides through the scan as a stacked scalar.
    """

    name: str
    arch_type: str                     # dense|moe|ssm|hybrid|vlm|audio
    source: str                        # citation bracket from the assignment
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads

    # --- attention ---
    attention_kind: str = "gqa"        # gqa | mla
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0            # 0 = full attention
    local_global_pattern: Tuple[int, int] = (0, 1)  # (local, global) per repeat; gemma3=(5,1)
    swa_variant_window: int = 4096     # window used when forcing SWA for long_500k

    # --- MLA (deepseek-v2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_layer_period: int = 1          # MoE every k-th layer (jamba: 2); dense FFN otherwise
    first_dense_layers: int = 0        # deepseek-v2: first layer is dense FFN
    router_aux_loss: float = 0.001

    # --- SSM (mamba / rwkv6) ---
    block_pattern: Tuple[str, ...] = ("attn",)   # repeating kinds; len divides num_layers
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2

    # --- embeddings / head ---
    tie_embeddings: bool = True
    pad_vocab: bool = True

    # --- modality frontend stubs ---
    frontend: Optional[str] = None     # None | "vision_stub" | "audio_stub"
    num_prefix_tokens: int = 0         # vlm: patch-embedding tokens prepended
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0           # whisper: 1500 frames

    # --- norm / act ---
    norm_eps: float = 1e-6
    act: str = "silu"                  # silu (swiglu) | gelu

    # --- long_500k policy ---
    long_context_mode: str = "swa"     # native|swa|state|skip (see DESIGN.md §5)

    # --- perf knobs (hillclimb axes, see EXPERIMENTS.md §Perf) ---
    mla_absorbed: bool = False         # MLA decode in latent space (deepseek)

    # --- the paper: split point as a fraction of depth (layer j) ---
    split_fraction: float = 0.5

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_layers % len(self.block_pattern) == 0, (
            self.name, self.num_layers, self.block_pattern)

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, VOCAB_PAD) if self.pad_vocab else self.vocab_size

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:          # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def split_layer(self) -> int:
        """Layer index j at which the paper splits lower/upper."""
        j = int(round(self.num_layers * self.split_fraction))
        return max(1, min(self.num_layers - 1, j))

    def layer_kinds(self) -> Tuple[str, ...]:
        reps = self.num_layers // len(self.block_pattern)
        return tuple(self.block_pattern) * reps

    def window_sizes(self, seq_len: int, force_swa: bool = False) -> Tuple[int, ...]:
        """Per-attention-layer sliding windows (0 = full). Data, not structure."""
        loc, glob = self.local_global_pattern
        out = []
        n_attn = sum(1 for k in self.layer_kinds() if k == "attn")
        for i in range(n_attn):
            if force_swa:
                # long_500k SWA variant: every attention layer windowed.
                w = self.sliding_window or self.swa_variant_window
            elif loc > 0:
                w = self.sliding_window if (i % (loc + glob)) < loc else 0
            else:
                w = self.sliding_window
            out.append(w)
        return tuple(out)

    def num_params(self) -> int:
        """Analytic parameter count (used for 6ND roofline terms)."""
        from repro_torch.models.registry import count_params  # lazy, avoids cycle
        return count_params(self)

    def active_params(self) -> int:
        from repro_torch.models.registry import count_params
        return count_params(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (see brief: <=2 layers,
        d_model<=512, <=4 experts)."""
        pat = self.block_pattern
        nl = len(pat) if len(pat) > 1 else 2
        d_model = min(self.d_model, 128)
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, 2))
        changes = dict(
            num_layers=nl,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32,
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq_len=min(self.encoder_seq_len, 16),
            num_prefix_tokens=min(self.num_prefix_tokens, 8),
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            swa_variant_window=16,
        )
        if self.is_moe:
            changes.update(num_experts=4, num_experts_per_tok=2,
                           num_shared_experts=min(self.num_shared_experts, 1))
        if self.attention_kind == "mla":
            changes.update(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=32,
                           qk_rope_head_dim=16, v_head_dim=32, head_dim=48)
        return replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


TRANSPORT_CODECS = ("raw_f32", "f16", "int8")
PCA_SOLVERS = ("exact", "randomized")


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
    distributed_selection: bool = False  # the cohort engine
    selection_chunk_size: int = 0      # accepted; the port selects per client
    # --- PCA engine of the selection: "exact" | "randomized" ---
    pca_solver: str = "exact"
    # --- observability (repro_torch.obs; span trace + metrics) ---
    observability: bool = False        # off: every obs hook is a NullTracer
    # --- transport (repro_torch.fl.transport; exact frame bytes) ---
    transport_codec: str = "raw_f32"   # raw_f32 | f16 | int8
    transport_checksum: bool = False   # CRC32 trailer on every frame

    def __post_init__(self):
        if self.pca_solver not in PCA_SOLVERS:
            raise ValueError(f"unknown PCA solver {self.pca_solver!r} "
                             f"(have {list(PCA_SOLVERS)})")
        if self.transport_codec not in TRANSPORT_CODECS:
            raise ValueError(f"unknown transport codec "
                             f"{self.transport_codec!r} (have "
                             f"{list(TRANSPORT_CODECS)})")


@dataclass(frozen=True)
class TrainConfig:
    """The federated LM training step's knobs (``launch/steps.py``
    ``make_train_step``), a copy of ``repro.configs.base.TrainConfig``.

    On a mesh the step's cohorts ride the fed axes that
    ``launch/specs.py`` ``fed_layout`` picks ("data", with "pod" before it
    on two pods), as the reference's; ``fed_axis`` is not read there, nor
    in the reference. ``seq_shard_activations`` picks the head-aware
    plan of the train layout (``launch/specs.py`` ``input_specs``) and,
    on a model axis, splits the hidden states between blocks on the
    sequence over "model" (``models/model_axis.py`` ``seq_split``; an
    MoE then needs each rank's chunk of a row to be whole groups of
    512)."""
    local_steps: int = 2               # L local SGD steps between FedAvg syncs
    microbatch: int = 8                # tokens rows per grad-accum microstep
    lr: float = 0.1
    momentum: float = 0.0
    weight_decay: float = 0.0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    fed_axis: str = "data"             # accepted; fed_layout picks the axes
    remat: bool = True
    # paper technique in the step:
    split_fl: bool = True              # lower=FedAvg, upper=metadata-trained
    meta_clusters: int = 8             # clusters per cohort for selection
    meta_steps: int = 2                # server-side upper-training steps
    pca_components: int = 64
    seq_shard_activations: bool = False  # the train plan's head_aware
    fedavg_compress: str = ""            # "" | "bf16" (delta sum dtype)
