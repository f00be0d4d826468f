"""Parity of the port's WRN (``repro_torch.models.wrn``) with the reference
(``repro.models.wrn``) on the CPU at ``WRNConfig().reduced()`` (WRN-10-1,
16x16 inputs): lower, upper and full forwards and the loss gradients agree
to 2e-3 (f32), with the reference's initial weights carried across by
``params_from_jax``. The upper part starts with stride-2 blocks, whose
"SAME" padding (0 before, 1 after) PyTorch's ``padding=1`` would get wrong.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.wrn_cifar import WRNConfig as JWRNConfig
from repro.models import wrn as jwrn
from repro_torch.configs.wrn_cifar import WRNConfig
from repro_torch.core.split import make_split_wrn
from repro_torch.models import wrn
from repro_torch.optim import value_and_grad
from test_torch_round import one_torch_thread  # noqa: F401

TOL = 2e-3


@pytest.fixture(scope="module")
def setup():
    jcfg = JWRNConfig().reduced()
    jparams = jwrn.init_wrn(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jparams)
    model = make_split_wrn(WRNConfig().reduced())
    params = wrn.params_from_jax(tree)
    r = np.random.default_rng(0)
    x = r.normal(size=(6, 16, 16, 3)).astype(np.float32)
    y = r.integers(0, 10, 6).astype(np.int32)
    return jcfg, jparams, tree, model, params, x, y


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_params_round_trip(setup):
    _, _, tree, model, params, _, _ = setup
    assert set(params) == {k for k, _ in model.module.named_parameters()}
    for k, p in model.module.named_parameters():
        assert tuple(params[k].shape) == tuple(p.shape), k
    back = wrn.params_to_jax(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_lower_upper_full_forward(setup):
    jcfg, jparams, _, model, params, x, _ = setup
    jacts = jwrn.wrn_lower(jcfg, jparams, jnp.asarray(x))
    acts = model.apply_lower(params, torch.from_numpy(x))
    assert tuple(acts.shape) == (6, 16, 16, 16)          # NHWC maps
    _close(acts.detach(), jacts)
    up = model.apply_upper(model.split(params)[1], acts)
    _close(up.detach(), jwrn.wrn_upper(jcfg, jparams, jacts))
    _close(model.apply(params, torch.from_numpy(x)).detach(),
           jwrn.wrn_apply(jcfg, jparams, jnp.asarray(x)))


def test_loss_gradients(setup):
    jcfg, jparams, _, model, params, x, y = setup
    jm = jwrn.make_split_wrn(jcfg)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jparams, (jnp.asarray(x), jnp.asarray(y)))
    loss, grads = value_and_grad(model.loss, params, torch.from_numpy(x),
                                 torch.from_numpy(y))
    _close(loss, jloss)
    gtree = wrn.params_to_jax(grads)
    for a, b in zip(jax.tree.leaves(gtree), jax.tree.leaves(jgrads)):
        _close(a, b)


def test_upper_loss_per_sample(setup):
    jcfg, jparams, _, model, params, x, y = setup
    jm = jwrn.make_split_wrn(jcfg)
    jacts = jm.apply_lower(jparams, jnp.asarray(x))
    want = jm.upper_loss(jparams, jacts, jnp.asarray(y))
    got = model.upper_loss(model.split(params)[1],
                           torch.from_numpy(np.asarray(jacts)),
                           torch.from_numpy(y))
    assert tuple(got.shape) == (6,)
    _close(got.detach(), want)


def test_same_padding_stride2_matches_xla():
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 32, 32, 16)).astype(np.float32)
    w = r.normal(size=(3, 3, 16, 32)).astype(np.float32)
    want = np.asarray(jwrn.conv(jnp.asarray(x), jnp.asarray(w), 2))
    conv = wrn.Conv(16, 32, 3, 2)
    params = {"weight": torch.from_numpy(w).permute(3, 2, 0, 1)}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = torch.func.functional_call(conv, params, (xt,))
    _close(got.permute(0, 2, 3, 1).detach(), want)
    # the symmetric padding PyTorch users reach for samples other pixels
    sym = F.conv2d(xt, params["weight"], stride=2, padding=1)
    assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 1.0


def test_init_params_shapes_and_scales():
    model = make_split_wrn(WRNConfig().reduced())
    p = model.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    for k, v in model.module.named_parameters():
        assert tuple(p[k].shape) == tuple(v.shape)
    assert torch.all(p["upper.bn_out.weight"] == 1)
    assert torch.all(p["upper.fc.bias"] == 0)
    w = p["lower.group1.0.conv1.weight"]
    assert abs(float(w.std()) - (2.0 / (9 * 16)) ** 0.5) < 0.03
