"""Parity of the port's split LM and tree training pieces with the
reference's, on the CPU.

``make_split_lm`` for ``llama3.2-1b`` and ``qwen2-0.5b`` ``.reduced()``
(both tie their embeddings; qwen2's is also run untied, so the ``lm_head``
keys are held too), ``qwen3-moe-30b-a3b`` (MoE FFN, untied; its loss
and upper loss carry the load-balance term), ``deepseek-v2-236b`` (MLA,
its dense layer 0 below the split and an MoE layer above) and
``rwkv6-3b`` (RWKV blocks; the gradient runs through the chunked WKV) in
f32, from ``repro``'s parameters (norm weights, qkv biases and RWKV's
per-channel vectors perturbed) carried across by ``params_from_jax``:
``split`` / ``merge`` leaf by leaf and bit for bit (the reference's keys:
``embed_head`` when tied, ``lm_head`` when not), ``apply_lower``,
``upper_loss`` on the same hidden states, and ``loss`` with its gradient
w.r.t. every leaf (also at S=2050, where both packages take their chunked
attention and differentiate it through their recompute VJP). The tree
optimizer (``sgd`` with momentum, Nesterov and weight decay),
``local_update_tree``, ``weight_average`` over trees and ``meta_train``
over the upper tree with (M, T) targets and the reference's permutations
against ``repro``'s. Level: 2e-3 (f32); ``remat`` changes no bit, with
the MoE's load-balance term summed through the checkpointed layers too.
``models.make_split_model`` (a config or an id) is ``make_split_lm``'s
split, and the reference's.
``core.compose.evaluate`` scores a ``SplitLM`` by next-token accuracy as
``repro``'s does, within one token's share, with T unequal and equal to
the batch size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import fedavg as jfa
from repro.core.compose import evaluate as jevaluate
from repro.core.meta_training import meta_train as jmeta_train
from repro.models import make_split_model as jmake_split_model
from repro.models.transformer import make_split_lm as jmake_split_lm
from repro.optim import sgd as jsgd
from repro_torch.configs import get_config
from repro_torch.core import fedavg as fa
from repro_torch.core.compose import evaluate
from repro_torch.core.meta_training import meta_train
from repro_torch.models import make_split_model
from repro_torch.models.transformer import (LM, make_split_lm,
                                            params_from_jax, tree_map)
from repro_torch.optim import sgd, tree_leaves, value_and_grad
from test_torch_round import one_torch_thread  # noqa: F401

TOL = 2e-3
ARCHS = {"llama3.2-1b": {}, "qwen2-0.5b": {},
         "qwen2-0.5b-untied": {"tie_embeddings": False},
         "qwen3-moe-30b-a3b": {}, "deepseek-v2-236b": {}, "rwkv6-3b": {}}


def _perturb(params, seed):
    """Norm weights (and RWKV's ``ln_x``) 1 + 0.1 N(0,1), qkv biases and
    RWKV's bonus 0.1 N(0,1), RWKV's mixing coefficients 0.5 + 0.1 N(0,1)
    and decay bias -6 + N(0,1), from numpy."""
    r = np.random.default_rng(seed)

    def f(path, x):
        name = str(getattr(path[-1], "key", ""))
        if "norm" in name or name == "ln_x" or name.startswith("mu_"):
            return x + 0.1 * r.normal(size=x.shape).astype(np.float32)
        if name in ("bq", "bk", "bv", "bonus"):
            return 0.1 * r.normal(size=x.shape).astype(np.float32)
        if name == "decay_bias":
            return x + r.normal(size=x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, jax.tree.map(np.asarray,
                                                            params))


def _configs(name, **changes):
    arch = name.replace("-untied", "")
    changes = {**ARCHS[name], **changes}
    return (dataclasses.replace(jget_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def split(request):
    jcfg, cfg = _configs(request.param)
    jmodel, jlm = jmake_split_lm(jcfg)
    model, lm = make_split_lm(cfg)
    tree = _perturb(jlm.init(jax.random.PRNGKey(1)), seed=2)
    return (jmodel, model, tree, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg, lm=lm), cfg)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _np(tree):
    return jax.tree.leaves(tree_map(lambda t: t.detach().numpy(), tree))


def test_split_and_merge_have_the_references_leaves(split):
    jmodel, model, tree, jparams, params, cfg = split
    assert model.split_layer == jmodel.split_layer
    for jpart, part in zip(jmodel.split(tree), model.split(params)):
        assert jax.tree.structure(jpart) == jax.tree.structure(
            tree_map(lambda t: t.numpy(), part))
        for a, b in zip(jax.tree.leaves(jpart), _np(part)):
            assert np.array_equal(a, b)
    assert ("embed_head" in model.split(params)[1]) == cfg.tie_embeddings
    assert ("lm_head" in model.split(params)[1]) != cfg.tie_embeddings
    merged = model.merge(*model.split(params))
    assert sorted(merged) == sorted(params)
    for key in params:
        for a, b in zip(tree_leaves(merged[key]), tree_leaves(params[key])):
            assert a is b


def test_apply_lower_and_upper_loss_match(split):
    jmodel, model, _, jparams, params, cfg = split
    toks = _tokens(cfg.vocab_size, (3, 24))
    want = jax.jit(jmodel.apply_lower)(jparams, jnp.asarray(toks))
    got = model.apply_lower(params, torch.from_numpy(toks))
    _close(got.numpy(), want)
    acts = np.random.default_rng(3).normal(size=want.shape).astype(
        np.float32)
    jup, up = jmodel.split(jparams)[1], model.split(params)[1]
    _close(model.upper_loss(up, torch.from_numpy(acts),
                            torch.from_numpy(toks)).numpy(),
           jmodel.upper_loss(jup, jnp.asarray(acts), jnp.asarray(toks)))
    _close(model.apply_upper(params, torch.from_numpy(acts)).numpy(),
           jmodel.apply_upper(jparams, jnp.asarray(acts)))


def _loss_and_gradient_match(jmodel, model, jparams, params, toks):
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, (jnp.asarray(toks),))
    loss, grads = value_and_grad(model.loss, params,
                                 (torch.from_numpy(toks),))
    _close(loss.numpy(), jloss)
    for a, b in zip(_np(grads), jax.tree.leaves(jgrads)):
        _close(a, b)


def test_loss_and_its_gradient_match(split):
    jmodel, model, _, jparams, params, cfg = split
    _loss_and_gradient_match(jmodel, model, jparams, params,
                             _tokens(cfg.vocab_size, (2, 24), seed=5))


def test_loss_gradient_matches_on_the_chunked_branch():
    """S = 2050 > 2048: both packages differentiate their chunked
    attention (the reference's custom VJP, the port's ``FlashAttention``
    over a ragged last chunk)."""
    jcfg, cfg = _configs("llama3.2-1b")
    jmodel, jlm = jmake_split_lm(jcfg)
    model, lm = make_split_lm(cfg)
    tree = _perturb(jlm.init(jax.random.PRNGKey(3)), seed=4)
    _loss_and_gradient_match(jmodel, model, jax.tree.map(jnp.asarray, tree),
                             params_from_jax(tree, cfg, lm=lm),
                             _tokens(cfg.vocab_size, (1, 2050), seed=6))


def test_remat_changes_no_bit_of_the_gradient():
    """``LM(remat=True)`` checkpoints each scan repeat: the gradient of a
    4-layer model (two scan stages with the split) is the same bits."""
    _, cfg = _configs("llama3.2-1b", num_layers=4)
    model, lm = make_split_lm(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 20), seed=6))
    assert all(st.kind == "scan" for st in lm.stages)
    grads = []
    for remat in (False, True):
        lm.remat = remat
        grads.append(value_and_grad(model.loss, params, (toks,))[1])
    for a, b in zip(*(tree_leaves(g) for g in grads)):
        assert torch.equal(a, b)


def test_remat_changes_no_bit_of_the_moe_gradient():
    """The same for a 4-layer reduced qwen3-moe: the load-balance term
    leaves each checkpointed layer beside its hidden state."""
    _, cfg = _configs("qwen3-moe-30b-a3b", num_layers=4)
    model, lm = make_split_lm(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 20), seed=6))
    assert all(st.kind == "scan" for st in lm.stages)
    out = []
    for remat in (False, True):
        lm.remat = remat
        out.append(value_and_grad(model.loss, params, (toks,)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(*(tree_leaves(g) for _, g in out)):
        assert torch.equal(a, b)
    assert any(bool(g.any()) for g in tree_leaves(
        [u["ffn"]["router"] for st in out[1][1]["stages"] for u in st]))


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "phi3-medium-14b",
                                  "llama3.2-1b"])
def test_make_split_model_is_make_split_lm_and_the_references(name):
    """By id at full width (the stages and split layer only: nothing is
    drawn) and by a reduced config at split layer 1 (the split leaves,
    bit for bit against ``make_split_lm``'s and the reference's)."""
    model, lm = make_split_model(name)
    jmodel, jlm = jmake_split_model(name)
    want_model, want_lm = make_split_lm(get_config(name))
    assert model.split_layer == want_model.split_layer == jmodel.split_layer
    assert ([dataclasses.astuple(s) for s in lm.stages]
            == [dataclasses.astuple(s) for s in want_lm.stages]
            == [dataclasses.astuple(s) for s in jlm.stages])
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    model, lm = make_split_model(cfg, 1)
    jmodel, jlm = jmake_split_model(jcfg, 1)
    want_model, _ = make_split_lm(cfg, 1)
    tree = _perturb(jlm.init(jax.random.PRNGKey(7)), seed=8)
    params = params_from_jax(tree, cfg, lm=lm)
    for part, want, jpart in zip(model.split(params),
                                 want_model.split(params),
                                 jmodel.split(tree)):
        assert sorted(part) == sorted(want) == sorted(jpart)
        for a, b, c in zip(_np(part), _np(want), jax.tree.leaves(jpart)):
            assert np.array_equal(a, b) and np.array_equal(a, c)


def test_loss_refuses_the_references_extras():
    """What ``LM.loss`` refuses of a batch: a dict key that is neither
    "tokens" nor one of the reference's extras (which are taken: the test
    below); a dict of "tokens" alone is the tokens' loss."""
    _, cfg = _configs("llama3.2-1b")
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.randint(cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(lm.loss(params, {"tokens": toks}),
                       lm.loss(params, toks))
    with pytest.raises(ValueError, match="labels"):
        lm.loss(params, {"tokens": toks, "labels": toks})


def test_loss_takes_the_references_extras():
    """``LM.loss`` and ``SplitLM.loss`` take internvl2's prefix: the
    text's predictions start after its ``num_prefix_tokens`` positions.
    The extras' parity with ``repro`` is in
    ``tests/test_torch_train_extras.py``."""
    vcfg = get_config("internvl2-26b").reduced()
    vtoks = torch.randint(vcfg.vocab_size, (2, 6),
                          generator=torch.Generator().manual_seed(1))
    model, vlm = make_split_lm(vcfg)
    vparams = vlm.init(torch.Generator().manual_seed(2))
    prefix = torch.randn(2, vcfg.num_prefix_tokens, vcfg.d_model,
                         generator=torch.Generator().manual_seed(3))
    logits, _, _ = vlm.apply(vparams, vtoks, prefix_embeds=prefix)
    lp = torch.log_softmax(logits[:, vcfg.num_prefix_tokens:-1], -1)
    want = -torch.gather(lp, -1, vtoks[:, 1:, None].long()).mean()
    batch = {"tokens": vtoks, "prefix_embeds": prefix}
    for got in (vlm.loss(vparams, batch), model.loss(vparams, batch)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _tree(rng):
    """A nested tree (dicts, a list, a tuple) of numpy leaves."""
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  (rng.normal(size=(2, 2)).astype(np.float32),)]}


@pytest.mark.parametrize("momentum,nesterov,wd", [
    (0.0, False, 0.0), (0.9, False, 0.0), (0.9, True, 1e-3),
    (0.0, False, 1e-2)])
def test_sgd_over_trees_matches_the_reference(momentum, nesterov, wd):
    rng = np.random.default_rng(8)
    p0, grads = _tree(rng), [_tree(rng) for _ in range(3)]
    jopt = jsgd(0.1, momentum=momentum, nesterov=nesterov, weight_decay=wd)
    opt = sgd(0.1, momentum=momentum, nesterov=nesterov, weight_decay=wd)
    jp, js = jax.tree.map(jnp.asarray, p0), None
    tp = tree_map(torch.from_numpy, p0)
    js, ts = jopt.init(jp), opt.init(tp)
    for g in grads:
        jp, js = jopt.apply(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = opt.apply(tree_map(torch.from_numpy, g), ts, tp)
    for a, b in zip(_np(tp), jax.tree.leaves(jp)):
        _close(a, b, 1e-6)
    assert isinstance(tp["b"][1], tuple)


def test_local_update_weight_average_and_meta_train_over_trees():
    """LocalUpdate (3 steps of SGD on ``loss``), FedAvg of two clients,
    then MetaTraining of the upper tree on (M, T) next-token targets with
    the reference's permutations, as ``examples/federated_lm.py`` runs
    them (llama3.2-1b reduced)."""
    jcfg, cfg = _configs("llama3.2-1b")
    jmodel, jlm = jmake_split_lm(jcfg)
    model, lm = make_split_lm(cfg)
    tree = _perturb(jlm.init(jax.random.PRNGKey(5)), seed=6)
    jparams, params = (jax.tree.map(jnp.asarray, tree),
                       params_from_jax(tree, cfg, lm=lm))
    toks = _tokens(cfg.vocab_size, (2, 3, 4, 16), seed=9)
    jopt, opt = jsgd(0.05), sgd(0.05)
    jclients, clients = [], []
    for c in range(2):
        jp, _, jl = jfa.local_update(
            jparams, jopt, jopt.init(jparams), (jnp.asarray(toks[c]),),
            lambda p_, b: jmodel.loss(p_, (b[0],)))
        tp, _, tl = fa.local_update_tree(
            params, opt, opt.init(params), torch.from_numpy(toks[c]),
            lambda p_, b: model.loss(p_, (b,)))
        _close(tl.numpy(), jl)
        jclients.append(jp)
        clients.append(tp)
    javg, avg = jfa.weight_average(jclients), fa.weight_average(clients)
    for a, b in zip(_np(avg), jax.tree.leaves(javg)):
        _close(a, b)
    # meta-training of the upper part on 8 sequences' hidden states
    seqs = toks[:, 0].reshape(8, 16)
    acts = np.array(jmodel.apply_lower(jparams, jnp.asarray(seqs)))
    valid = np.arange(8) != 5
    key = jax.random.PRNGKey(4)
    perms = np.stack([np.asarray(jax.random.permutation(k, 8))
                      for k in jax.random.split(key, 3)])
    jup, jlosses = jmeta_train(
        jmodel.split(jparams)[1], jmodel.upper_loss, jnp.asarray(acts),
        jnp.asarray(seqs), epochs=3, batch_size=4, lr=0.05, key=key,
        valid=jnp.asarray(valid))
    up, losses = meta_train(
        model.split(params)[1], model.upper_loss, torch.from_numpy(acts),
        torch.from_numpy(seqs), torch.from_numpy(perms), batch_size=4,
        lr=0.05, valid=torch.from_numpy(valid))
    _close(losses.numpy(), jlosses)
    for a, b in zip(_np(up), jax.tree.leaves(jup)):
        _close(a, b)


def _half_greedy_tokens(jmodel, jparams, vocab, n, t, seed):
    """(n, t) tokens in which every other next token is the reference
    model's argmax (a causal model's logits at i do not read the token at
    i + 1), so the accuracy is near 1/2, not the near 0 of random
    tokens."""
    toks = _tokens(vocab, (n, t), seed)
    apply = jax.jit(jmodel.apply)
    for i in range(0, t - 1, 2):
        logits = np.asarray(apply(jparams, jnp.asarray(toks)))
        toks[:, i + 1] = logits[:, i].argmax(-1)
    return toks


@pytest.mark.parametrize("n,t,batch_size", [(4, 9, 200), (4, 4, 200),
                                            (6, 3, 3)])
def test_evaluate_scores_next_token_accuracy_as_the_reference(n, t,
                                                              batch_size):
    """A reduced llama3.2-1b ``SplitLM`` from the same weights: the port's
    ``evaluate`` equals ``repro``'s within one token's share, 1 / ((T-1)
    n), with T unequal to the batch size and equal to it (one batch of 4,
    two batches of 3)."""
    jcfg, cfg = _configs("llama3.2-1b")
    jmodel, jlm = jmake_split_lm(jcfg)
    model, lm = make_split_lm(cfg)
    tree = _perturb(jlm.init(jax.random.PRNGKey(1)), seed=2)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, lm=lm)
    toks = _half_greedy_tokens(jmodel, jparams, cfg.vocab_size, n, t, 9)
    y = np.zeros(n, np.int32)
    want = jevaluate(jmodel, jparams, toks, y, batch_size=batch_size)
    got = evaluate(model, params, torch.from_numpy(toks), torch.from_numpy(y),
                   batch_size=batch_size)
    assert want >= 0.3
    assert abs(got - want) <= 1.0 / ((t - 1) * n) + 1e-6
