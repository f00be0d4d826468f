"""Datasets. The container is offline, so CIFAR-10 is replaced by a synthetic
class-structured image dataset whose clustering structure makes the paper's
selection mechanism meaningful: each class is a mixture of
``modes_per_class`` Gaussian prototype images plus per-sample noise and
random shifts, so (a) per-class K-means finds real modes, and (b) a
representative-per-mode subset genuinely summarizes a client's data.

A numpy-only copy of ``repro.data.datasets``, so both packages draw
identical data from the same seeds.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Dataset:
    x: np.ndarray          # images (N,H,W,C) float32 or tokens (N,T) int32
    y: np.ndarray          # labels (N,) int32
    num_classes: int

    def __len__(self):
        return len(self.x)

    def subset(self, idx) -> "Dataset":
        return Dataset(self.x[idx], self.y[idx], self.num_classes)


def SyntheticImageDataset(num_samples: int = 10_000, image_size: int = 32,
                          channels: int = 3, num_classes: int = 10,
                          modes_per_class: int = 4, noise: float = 0.35,
                          seed: int = 0, structure_seed: int = 0) -> Dataset:
    """CIFAR-10 stand-in with explicit intra-class cluster structure.

    ``seed`` draws the samples; ``structure_seed`` draws the class/mode
    prototypes. They are separate so differently-seeded datasets (e.g. a
    train and a test split) describe the SAME classes — real datasets'
    classes do not change between splits."""
    srng = np.random.default_rng(structure_seed)
    rng = np.random.default_rng(seed)
    # low-frequency prototypes: random coefficients on a coarse grid, upsampled
    coarse = max(4, image_size // 4)
    protos = srng.normal(0, 1.0, (num_classes, modes_per_class, coarse, coarse, channels))
    protos = protos.repeat(image_size // coarse, axis=2).repeat(image_size // coarse, axis=3)
    y = rng.integers(0, num_classes, num_samples).astype(np.int32)
    modes = rng.integers(0, modes_per_class, num_samples)
    x = protos[y, modes].astype(np.float32)
    # nuisance: per-sample circular shift + pixel noise
    shifts = rng.integers(-2, 3, (num_samples, 2))
    for i in range(num_samples):
        x[i] = np.roll(x[i], tuple(shifts[i]), axis=(0, 1))
    x += rng.normal(0, noise, x.shape).astype(np.float32)
    # normalise roughly like CIFAR preprocessing
    x = (x - x.mean()) / (x.std() + 1e-6)
    return Dataset(x.astype(np.float32), y, num_classes)


def SyntheticActivationMaps(num_samples: int = 2500,
                            map_shape: tuple = (16, 16, 4),
                            num_classes: int = 10, modes_per_class: int = 4,
                            rank: int = 96, spectrum_decay: float = 0.9,
                            jitter: float = 0.3, noise: float = 0.01,
                            seed: int = 0, structure_seed: int = 0) -> Dataset:
    """Split-layer activation-map stand-in: per-class latent cluster modes
    pushed through a decaying-spectrum linear map plus a little isotropic
    noise — low-rank, mode-structured, the regime the paper's §3.1
    PCA + per-class K-means presumes (white noise would make selection
    meaningless). Shared by the selection benchmark and the identity
    tests so both validate the same data regime."""
    d = int(np.prod(map_shape))
    srng = np.random.default_rng(structure_seed)
    rng = np.random.default_rng(seed)
    spectrum = 3.0 * spectrum_decay ** np.arange(rank)
    w = srng.normal(size=(rank, d)).astype(np.float32) * spectrum[:, None]
    mode_z = srng.normal(
        size=(num_classes, modes_per_class, rank)).astype(np.float32) * 2.0
    y = rng.integers(0, num_classes, num_samples).astype(np.int32)
    modes = rng.integers(0, modes_per_class, num_samples)
    z = (mode_z[y, modes]
         + jitter * rng.normal(size=(num_samples, rank)).astype(np.float32))
    x = z @ w + noise * rng.normal(size=(num_samples, d)).astype(np.float32)
    return Dataset(x.reshape((num_samples,) + map_shape), y, num_classes)


def SyntheticTokenDataset(num_samples: int = 2048, seq_len: int = 128,
                          vocab_size: int = 512, num_classes: int = 8,
                          seed: int = 0, structure_seed: int = 0) -> Dataset:
    """Token sequences drawn from per-class bigram processes (so hidden states
    at the split layer cluster by class, mirroring the paper's setting for the
    LM generalization). ``structure_seed`` fixes the per-class processes
    independently of the sampling ``seed`` (see SyntheticImageDataset)."""
    srng = np.random.default_rng(structure_seed)
    rng = np.random.default_rng(seed)
    # per-class sparse bigram transition tables
    tables = srng.dirichlet(np.ones(vocab_size) * 0.05, (num_classes, vocab_size))
    y = rng.integers(0, num_classes, num_samples).astype(np.int32)
    x = np.zeros((num_samples, seq_len), np.int32)
    x[:, 0] = rng.integers(0, vocab_size, num_samples)
    u = rng.random((num_samples, seq_len))
    for t in range(1, seq_len):
        cdf = np.cumsum(tables[y, x[:, t - 1]], axis=-1)
        x[:, t] = (u[:, t, None] > cdf).sum(-1).clip(0, vocab_size - 1)
    return Dataset(x, y, num_classes)
