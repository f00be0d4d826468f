"""Parity of the port's MLA attention (``repro_torch.models.layers``
``mla_init``, ``mla_cache_init``, ``mla_apply``) with the reference's
(``repro.models.layers``), on the CPU.

One MLA layer of deepseek-v2-236b's reduced family (d_model 128, 4 heads,
kv_lora 32, qk_nope 32, qk_rope 16, v 32) in f32, with ``q_lora_rank`` 0
(``w_q``) and 24 (``w_dq``, ``q_norm``, ``w_uq``); its weights from
``repro``'s ``mla_init`` (the norm weights perturbed), the same numpy
inputs in both packages, the reference's function ``jax.jit``ed. Cases:
prefill at S=32 (``sdpa_full``) and S=2050 (``sdpa_chunked``, whose last
chunk is padded and masked); 8 decode steps at batch 3 over a 6-slot
latent ring that wraps, in the naive form (``sdpa_decode`` over the
rebuilt heads) and the absorbed one (latent-space einsums), the outputs
and both cache tensors held at every step, and the two forms against each
other; a 3-layer deepseek (the dense layer 0 unrolled, then a scan stage
of 2 MoE layers) decoding through ``LM.apply``, so that both branches of
the stage loop carry MLA caches. Level: 2e-3. ``mla_init``'s leaves and
shapes are the reference's, on the ``meta`` device too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jL
from repro.models.transformer import LM as JLM
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.transformer import LM, params_from_jax
from test_torch_round import one_torch_thread  # noqa: F401

TOL = 2e-3
ARCH = "deepseek-v2-236b"


def _configs(**changes):
    return (dataclasses.replace(jget_config(ARCH).reduced(), **changes),
            dataclasses.replace(get_config(ARCH).reduced(), **changes))


def _params(jcfg, seed):
    """``repro``'s MLA weights (numpy), the norm weights 1 + 0.1 N(0,1)."""
    p = jax.tree.map(np.asarray, jL.mla_init(jax.random.PRNGKey(seed),
                                             jcfg))
    r = np.random.default_rng(seed)
    return {k: (v + 0.1 * r.normal(size=v.shape).astype(np.float32)
                if "norm" in k else v) for k, v in p.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_init_has_the_references_leaves(q_lora):
    jcfg, cfg = _configs(q_lora_rank=q_lora)
    want = jL.mla_init(jax.random.PRNGKey(0), jcfg)
    for got in (L.mla_init(L.ParamInit(torch.Generator().manual_seed(0)),
                           cfg),
                L.mla_init(L.ParamInit(None, "meta"), cfg)):
        assert sorted(got) == sorted(want)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
    assert ("w_dq" in want) == (q_lora > 0)
    cache = L.mla_cache_init(cfg, 3, 6, torch.float32, lead=(2,))
    jcache = jL.mla_cache_init(jcfg, 3, 6, jnp.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: (2,) + tuple(v.shape) for k, v in jcache.items()}


@pytest.mark.parametrize("q_lora,s", [(0, 32), (24, 32), (24, 2050)])
def test_mla_prefill_matches(q_lora, s):
    """S=32 runs ``sdpa_full`` in both packages, S=2050 ``sdpa_chunked``
    (values padded to dn + dr and sliced back to dv in both)."""
    jcfg, cfg = _configs(q_lora_rank=q_lora)
    p = _params(jcfg, seed=1 + q_lora)
    x = _x(cfg, (1 if s > 2048 else 2, s), seed=s)
    want, _ = jax.jit(lambda p, x: jL.mla_apply(
        p, x, cfg=jcfg, mode="full"))(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x))
    got, cache = L.mla_apply(_torch(p), torch.from_numpy(x), cfg=cfg,
                             mode="full")
    assert cache is None and got.shape == x.shape
    _close(got, want)


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_decode_over_a_ring_that_wraps(absorbed, q_lora):
    """8 steps at batch 3 on 6 slots, the rows at different positions (the
    ring wraps on the last steps of each): outputs and both cache tensors
    within 2e-3 at every step; the caller's cache tensors are the ones
    written and returned."""
    jcfg, cfg = _configs(q_lora_rank=q_lora)
    p = _params(jcfg, seed=3)
    jp, tp = jax.tree.map(jnp.asarray, p), _torch(p)
    step = jax.jit(lambda p, x, c, pos: jL.mla_apply(
        p, x, cfg=jcfg, mode="decode", cache=c, pos=pos, absorbed=absorbed))
    jcache = jL.mla_cache_init(jcfg, 3, 6, jnp.float32)
    cache = L.mla_cache_init(cfg, 3, 6, torch.float32)
    ring = dict(cache)
    start = np.array([0, 2, 5], np.int32)
    xs = _x(cfg, (3, 8), seed=4 + q_lora)
    for i in range(8):
        pos = start + i
        want, jcache = step(jp, jnp.asarray(xs[:, i:i + 1]), jcache,
                            jnp.asarray(pos))
        got, cache = L.mla_apply(tp, torch.from_numpy(xs[:, i:i + 1]),
                                 cfg=cfg, mode="decode", cache=cache,
                                 pos=torch.from_numpy(pos),
                                 absorbed=absorbed)
        _close(got, want)
        for name in ("c_kv", "k_rope"):
            assert cache[name] is ring[name]
            _close(cache[name], jcache[name])


def test_mla_naive_and_absorbed_decode_agree():
    """The two decode forms compute the same attention (the absorbed one
    reassociates the products): within 2e-3 over 5 steps."""
    _, cfg = _configs(q_lora_rank=24)
    g = torch.Generator().manual_seed(5)
    p = L.mla_init(L.ParamInit(g), cfg)
    caches = [L.mla_cache_init(cfg, 2, 8, torch.float32) for _ in range(2)]
    xs = torch.randn(2, 5, cfg.d_model, generator=g)
    for i in range(5):
        pos = torch.tensor([i, i + 1], dtype=torch.int32)
        a, _ = L.mla_apply(p, xs[:, i:i + 1], cfg=cfg, mode="decode",
                           cache=caches[0], pos=pos, absorbed=False)
        b, _ = L.mla_apply(p, xs[:, i:i + 1], cfg=cfg, mode="decode",
                           cache=caches[1], pos=pos, absorbed=True)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_lm_decodes_through_unrolled_and_scanned_stages(absorbed):
    """A 3-layer deepseek (layer 0 dense and unrolled, layers 1-2 MoE in a
    scan stage with stacked latent caches): 8 teacher-forced decode steps
    at batch 3 on a 6-slot ring, logits within 2e-3 of ``repro``'s, and
    the stacked caches equal to its."""
    jcfg, cfg = _configs(num_layers=3, mla_absorbed=absorbed)
    jlm, lm = JLM(jcfg), LM(cfg)
    assert [(s.kind, s.repeats) for s in lm.stages] == [("unroll", 1),
                                                       ("scan", 2)]
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(6)))
    jparams, params = jax.tree.map(jnp.asarray, tree), params_from_jax(
        tree, cfg)
    jcache = jlm.init_cache(3, 6, dtype=jnp.float32)
    cache = lm.init_cache(3, 6, dtype=torch.float32)
    step = jax.jit(lambda p, t, c: jlm.apply(p, t, mode="decode", cache=c))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (3, 8)).astype(np.int32)
    for i in range(8):
        want, jcache, _ = step(jparams, jnp.asarray(toks[:, i:i + 1]),
                               jcache)
        got, cache, _ = lm.apply(params, torch.from_numpy(toks[:, i:i + 1]),
                                 mode="decode", cache=cache)
        _close(got, want)
    for si in range(2):
        for name in ("c_kv", "k_rope"):
            _close(cache["stages"][si][0]["mixer"][name],
                   jcache["stages"][si][0]["mixer"][name])
