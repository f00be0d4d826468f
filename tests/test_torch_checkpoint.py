"""The port's checkpoint (``repro_torch.checkpoint``) against
``repro.checkpoint``'s on-disk format, on the CPU.

Levels: bit-equal. Round trips of f32 / int / bool / bf16 leaves in nested
dicts, lists and tuples; the atomic write leaves no ``.tmp``;
``latest_step`` and ``max_to_keep`` as the reference's; a missing leaf is
a ``KeyError`` and a shape mismatch a ``ValueError``; a file the port
writes restores through ``repro.checkpoint`` (bf16 through ``ml_dtypes``)
and a file the reference writes restores through the port; a WRN W_G
saved as ``params_to_jax`` restores into the reference's ``init_wrn``
tree and back through ``params_from_jax``.
"""
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs.wrn_cifar import WRNConfig as JWRNConfig
from repro.models import wrn as jwrn
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_wrn_config
from repro_torch.core.split import make_split_wrn
from repro_torch.models import wrn


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(3, 4, generator=g),
        "layers": [{"k": torch.randn(2, 2, generator=g).to(torch.bfloat16),
                    "steps": torch.arange(5, dtype=torch.int64)},
                   {"mask": torch.tensor([True, False, True])}],
        "pair": (torch.tensor(7, dtype=torch.int32),
                 np.linspace(0, 1, 6, dtype=np.float32)),
        "none": None,
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, np.ndarray):
        return np.zeros_like(tree)
    return tree


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor)
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    elif a is None:
        assert b is None
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_round_trip_is_bit_equal_and_atomic(tmp_path):
    tree = _tree()
    path = ckpt.save_checkpoint(str(tmp_path), 3, tree, {"note": "x"})
    assert os.path.basename(path) == "ckpt_00000003.npz"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    got, meta = ckpt.restore_checkpoint(str(tmp_path), _zeros_like(tree))
    _assert_same(tree, got)
    assert meta == {"note": "x", "step": 3}
    # the reference's layout: jax.tree_util's paths and the bf16 view
    with np.load(path) as data:
        keys = sorted(k for k in data.files if k != "__meta__")
        assert data["layers/0/k"].dtype == np.uint16
    assert keys == sorted(["w", "layers/0/k", "layers/0/steps",
                           "layers/1/mask", "pair/0", "pair/1"])


def test_latest_step_and_max_to_keep(tmp_path):
    d = str(tmp_path / "run")
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d, {})
    mgr = ckpt.CheckpointManager(d, max_to_keep=2)
    for step in (1, 5, 3, 9):
        mgr.save(step, {"a": torch.full((2,), float(step))})
    assert sorted(os.listdir(d)) == ["ckpt_00000005.npz",
                                     "ckpt_00000009.npz"]
    assert mgr.latest == 9
    got, meta = mgr.restore({"a": torch.zeros(2)}, step=5)
    assert meta["step"] == 5 and torch.equal(got["a"], torch.full((2,), 5.))


def test_missing_leaf_and_shape_mismatch_are_refused(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 0, {"a": torch.zeros(2, 3)})
    with pytest.raises(KeyError, match="'b'"):
        ckpt.restore_checkpoint(str(tmp_path), {"b": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), {"a": torch.zeros(3, 2)})
    # the reference refuses the same file the same way
    with pytest.raises(KeyError):
        jckpt.restore_checkpoint(str(tmp_path), {"b": np.zeros((2, 3))})
    with pytest.raises(ValueError):
        jckpt.restore_checkpoint(str(tmp_path), {"a": np.zeros((3, 2))})


def test_restore_takes_the_targets_dtype(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 0, {"a": torch.arange(4.0)})
    got, _ = ckpt.restore_checkpoint(
        str(tmp_path), {"a": torch.zeros(4, dtype=torch.float64)})
    assert got["a"].dtype == torch.float64
    assert torch.equal(got["a"], torch.arange(4.0, dtype=torch.float64))
    got, _ = ckpt.restore_checkpoint(str(tmp_path),
                                     {"a": np.zeros(4, np.int32)})
    np.testing.assert_array_equal(got["a"], np.arange(4, dtype=np.int32))


def _as_numpy_tree(tree):
    """The reference's view of ``_tree``: numpy leaves, bf16 through
    ``ml_dtypes``."""
    def leaf(t):
        if isinstance(t, torch.Tensor):
            if t.dtype == torch.bfloat16:
                return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            return t.numpy()
        return t
    return jax.tree.map(leaf, tree, is_leaf=lambda t: isinstance(
        t, torch.Tensor))


def test_each_package_restores_the_others_files(tmp_path):
    tree = _tree(1)
    want = _as_numpy_tree(tree)
    # port -> reference
    ckpt.save_checkpoint(str(tmp_path / "port"), 2, tree)
    got, meta = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                         jax.tree.map(np.zeros_like, want))
    assert meta["step"] == 2
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    # reference -> port
    jckpt.save_checkpoint(str(tmp_path / "ref"), 4, want, {"by": "repro"})
    got, meta = ckpt.restore_checkpoint(str(tmp_path / "ref"),
                                        _zeros_like(tree))
    assert meta == {"by": "repro", "step": 4}
    _assert_same(tree, got)
    # a numpy target of the caller's own bf16 dtype gets the bits back
    got, _ = ckpt.restore_checkpoint(str(tmp_path / "ref"),
                                     jax.tree.map(np.zeros_like, want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_wrn_global_weights_cross_packages(tmp_path):
    """W_G saved as the reference's tree (``params_to_jax``) restores
    into ``init_wrn``'s tree, and back into the port through
    ``params_from_jax``, bit-equal."""
    model = make_split_wrn(get_wrn_config().reduced())
    params = model.init(torch.Generator().manual_seed(3),
                        torch.device("cpu"))
    ckpt.CheckpointManager(str(tmp_path)).save(
        7, wrn.params_to_jax(params), {"cfg": "reduced"})
    jcfg = JWRNConfig().reduced()
    target = jax.tree.map(np.asarray, jwrn.init_wrn(jcfg,
                                                    jax.random.PRNGKey(0)))
    got, meta = jckpt.CheckpointManager(str(tmp_path)).restore(target)
    assert meta == {"cfg": "reduced", "step": 7}
    back = wrn.params_from_jax(got)
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        assert torch.equal(back[k], v), k
    # and the reference's own weights through the port's restore
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, target)
    got, _ = ckpt.restore_checkpoint(str(tmp_path / "ref"),
                                     wrn.params_to_jax(params))
    ref_params = wrn.params_from_jax(target)
    for k, v in wrn.params_from_jax(got).items():
        assert torch.equal(v, ref_params[k]), k
