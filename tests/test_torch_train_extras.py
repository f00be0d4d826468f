"""Parity of the port's training with the reference's extras, on the CPU.

Whisper's reduced encoder-decoder (2 encoder and 2 decoder layers, 16
frames of ``enc_frames``) and internvl2's reduced VLM (2 layers, 8
``prefix_embeds`` through ``proj``), one reference LM each, shared by the
module's tests:

  * ``LM.loss`` and its gradient with the arch's extra against ``repro``'s
    ``jax.value_and_grad`` of ``LM.loss`` (with a prefix, the text's
    predictions start after its positions);
  * ``launch.steps.make_train_step`` with the extras beside the tokens
    (G = 2, L = 2, n_micro = 2, mb = 4, T = 16), ``split_fl`` on and off,
    against ``repro``'s step under ``jax.jit``, as
    ``tests/test_torch_train_step.py`` runs it: the reference's K-means
    first centres, as many clusters as probe rows. With ``split_fl`` the
    probe runs the lower part on its extras, the selected rows carry
    theirs, and the upper loss drops the prefix's positions or re-encodes
    the selected rows' frames with the averaged encoder.

Parameters from ``repro``'s init, inputs from numpy seeds, f32 compute.
Level: loss, gradient, ``meta_loss`` and every new parameter within 2e-3;
each parameter's update (new - init) within 2e-3 of the reference's
update's norm, which is not zero; ``selected`` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.transformer import LM as JLM
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import LM, params_from_jax, tree_map
from test_torch_round import one_torch_thread  # noqa: F401

TOL = 2e-3
G, L, N_MICRO, MB, T = 2, 2, 2, 4, 16
WHISPER, INTERNVL = "whisper-medium", "internvl2-26b"


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def _extra(cfg, lead, seed):
    """The arch's extra over the leading axes ``lead``, from numpy."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return "enc_frames", rng.normal(size=lead + (
            cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return "prefix_embeds", rng.normal(size=lead + (
        cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module", params=[WHISPER, INTERNVL])
def arch(request):
    """(configs, the reference's init as numpy, with its stages whole and
    split at the paper's layer as the train step splits them) of one
    reduced arch."""
    name = request.param
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    key = jax.random.PRNGKey(1)
    whole = jax.tree.map(np.asarray, JLM(jcfg).init(key))
    split = jax.tree.map(np.asarray, jmake_train_step(
        jcfg, JTrainConfig())[1].init(key))
    return jcfg, cfg, whole, split


def test_loss_and_gradient_with_the_extras_match(arch):
    jcfg, cfg, tree, _ = arch
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    key, ex = _extra(cfg, (2,), 3)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JLM(jcfg).loss(p, b)))(
        jax.tree.map(jnp.asarray, tree),
        {"tokens": jnp.asarray(toks), key: jnp.asarray(ex)})
    lm = LM(cfg)
    params = tree_map(lambda t: t.requires_grad_(True),
                      params_from_jax(tree, cfg))
    got = lm.loss(params, {"tokens": torch.from_numpy(toks),
                           key: torch.from_numpy(ex)})
    grads = torch.autograd.grad(got, jax.tree.leaves(
        tree_map(lambda t: t, params)))
    _close(got.detach(), want)
    want_leaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(want_leaves)
    for a, b in zip(grads, want_leaves):
        assert tuple(a.shape) == b.shape
        _close(a, b)


@pytest.mark.parametrize("split_fl", [True, False])
def test_train_step_with_the_extras_matches_the_reference(arch, split_fl):
    jcfg, cfg, _, tree = arch
    knobs = dict(dtype="float32", microbatch=MB, meta_clusters=MB,
                 split_fl=split_fl)
    jstep, _ = jmake_train_step(jcfg, JTrainConfig(**knobs))
    step, lm = make_train_step(cfg, TrainConfig(**knobs))
    jparams = jax.tree.map(
        lambda x: jnp.broadcast_to(jnp.asarray(x)[None], (G,) + x.shape),
        tree)
    params = tree_map(lambda t: t[None].expand((G,) + tuple(t.shape)),
                      params_from_jax(tree, cfg, lm=lm))
    lead = (G, L, N_MICRO, MB)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, lead + (T,)).astype(np.int32)
    key, ex = _extra(cfg, lead, 4)
    rkey = jax.random.PRNGKey(3)
    first = [int(jax.random.categorical(k, jnp.zeros(MB)))
             for k in jax.random.split(rkey, G)]

    jnew, _, jm = jax.jit(jstep)(
        jparams, (), {"tokens": jnp.asarray(toks), key: jnp.asarray(ex)},
        rkey)
    new, _, m = step(params, (), {"tokens": torch.from_numpy(toks),
                                  key: torch.from_numpy(ex)}, first)

    assert sorted(m) == sorted(jm)
    for name in m:
        if name == "selected":
            assert float(m[name]) == float(jm[name])
        else:
            _close(m[name].numpy(), jm[name])
    got = jax.tree.leaves(tree_map(lambda t: t.numpy(), new))
    want = jax.tree.leaves(jnew)
    assert len(got) == len(want) == len(jax.tree.leaves(tree))
    for a, b, old in zip(got, want, jax.tree.leaves(tree)):
        assert a.shape == b.shape
        _close(a, b)
        assert np.array_equal(a[0], a[1])       # every cohort gets W_G(t)
        # the update itself, against the reference's update's own size:
        # every leaf moves (the encoder's through the cross-attention's
        # gradient), and by the reference's step
        du, dw = a[0] - old, np.asarray(b)[0] - old
        size = np.linalg.norm(dw)
        assert size > 0
        assert np.linalg.norm(du - dw) <= TOL * size
