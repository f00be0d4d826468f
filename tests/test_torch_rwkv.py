"""Parity of the port's RWKV6 (``repro_torch.models.layers`` ``_wkv_chunked``,
``rwkv_init``, ``rwkv_apply``, ``rwkv_ffn_init``, ``rwkv_ffn_apply``) with
the reference's (``repro.models.layers``), on the CPU.

The chunked WKV on numpy inputs (r, k, v ~ N(0,1), the decay w in the
range ``rwkv_apply`` gives it, the bonus u ~ 0.5 N(0,1)) at s = 1, 64
(one chunk), 128 and 192 (several: the state carried from chunk to
chunk). One time-mix and one channel-mix layer of rwkv6-3b's reduced
family (d_model 128, 4 heads of 32, d_ff 256), their weights from
``repro``'s init with every per-channel vector perturbed (norms, the mixing
coefficients, the decay bias, the bonus: the init's bonus is zero), in
prefill at S=64 and over 6 decode steps at batch 3 (outputs and the new
state within 2e-3 at every step; the caller's cache tensors get the new
state). The reduced LM (2 layers in one scan stage, stacked states)
decoding through ``LM.apply`` for 8 steps: logits and the stacked
``state``, ``x_prev`` and ``ffn_x_prev`` equal to ``repro``'s; a state
that was not written back would leave step 0's. Decode from a zero state
gives the prefill's logits at every position (the recurrence is the
chunked form). Level: 2e-3, f32.
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
ARCH = "rwkv6-3b"


def _configs(**changes):
    return (dataclasses.replace(jget_config(ARCH).reduced(), **changes),
            dataclasses.replace(get_config(ARCH).reduced(), **changes))


def _perturb(tree, seed):
    """Norm weights and ``ln_x`` 1 + 0.1 N(0,1), the mixing coefficients
    0.5 + 0.2 N(0,1), the decay bias -6 + N(0,1), the bonus 0.5 N(0,1)."""
    r = np.random.default_rng(seed)

    def f(path, x):
        name = str(getattr(path[-1], "key", ""))
        noise = r.normal(size=x.shape).astype(np.float32)
        if "norm" in name or name == "ln_x":
            return x + 0.1 * noise
        if name.startswith("mu_"):
            return x + 0.2 * noise
        if name == "decay_bias":
            return x + noise
        if name == "bonus":
            return 0.5 * noise
        return x
    return jax.tree_util.tree_map_with_path(f, jax.tree.map(np.asarray,
                                                            tree))


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("s", [1, 64, 128, 192])
def test_wkv_chunked_matches(s):
    r = np.random.default_rng(s)
    b, h, hd = 2, 3, 16
    r_, k, v = (r.normal(size=(b, s, h, hd)).astype(np.float32)
                for _ in range(3))
    w = np.exp(-0.6065 * r.uniform(0, 1, (b, s, h, hd))).astype(np.float32)
    u = (0.5 * r.normal(size=(h, hd))).astype(np.float32)
    want = jax.jit(jL._wkv_chunked)(*map(jnp.asarray, (r_, k, v, w, u)))
    got = L._wkv_chunked(*map(torch.from_numpy, (r_, k, v, w, u)))
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    _close(got, want)


def test_rwkv_init_has_the_references_leaves():
    jcfg, cfg = _configs()
    for jinit, init in ((jL.rwkv_init, L.rwkv_init),
                        (jL.rwkv_ffn_init, L.rwkv_ffn_init)):
        want = jinit(jax.random.PRNGKey(0), jcfg)
        got = init(L.ParamInit(None, "meta"), cfg)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}


def _layers(jcfg, seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (_perturb(jL.rwkv_init(k1, jcfg), seed),
            _perturb(jL.rwkv_ffn_init(k2, jcfg), seed + 1))


def test_rwkv_time_and_channel_mix_prefill_match():
    jcfg, cfg = _configs()
    tm, cm = _layers(jcfg, seed=1)
    x = np.random.default_rng(2).normal(size=(2, 64, cfg.d_model)).astype(
        np.float32)
    want, _ = jax.jit(lambda p, x: jL.rwkv_apply(p, x, cfg=jcfg,
                                                 mode="full"))(
        jax.tree.map(jnp.asarray, tm), jnp.asarray(x))
    got, cache = L.rwkv_apply(_torch(tm), torch.from_numpy(x), cfg=cfg,
                              mode="full")
    assert cache is None
    _close(got, want)
    (want, wlast) = jax.jit(lambda p, x: jL.rwkv_ffn_apply(p, x, cfg=jcfg))(
        jax.tree.map(jnp.asarray, cm), jnp.asarray(x))
    got, last = L.rwkv_ffn_apply(_torch(cm), torch.from_numpy(x), cfg=cfg)
    _close(got, want)
    _close(last, wlast)


def test_rwkv_time_and_channel_mix_decode_match():
    """6 steps at batch 3 from a zero state: y, the state and the shifts
    within 2e-3 at every step, written into the caller's tensors."""
    jcfg, cfg = _configs()
    tm, cm = _layers(jcfg, seed=3)
    jtm, jcm = jax.tree.map(jnp.asarray, tm), jax.tree.map(jnp.asarray, cm)
    ttm, tcm = _torch(tm), _torch(cm)
    tstep = jax.jit(lambda p, x, c: jL.rwkv_apply(p, x, cfg=jcfg,
                                                  mode="decode", cache=c))
    cstep = jax.jit(lambda p, x, xp: jL.rwkv_ffn_apply(p, x, cfg=jcfg,
                                                       x_prev=xp))
    jcache = jL.rwkv_cache_init(jcfg, 3)
    cache = L.rwkv_cache_init(cfg, 3)
    state = dict(cache)
    jxp, xp = jnp.zeros((3, cfg.d_model)), torch.zeros(3, cfg.d_model)
    xs = np.random.default_rng(4).normal(size=(3, 6, cfg.d_model)).astype(
        np.float32)
    for i in range(6):
        x = xs[:, i:i + 1]
        want, jcache = tstep(jtm, jnp.asarray(x), jcache)
        got, cache = L.rwkv_apply(ttm, torch.from_numpy(x), cfg=cfg,
                                  mode="decode", cache=cache)
        _close(got, want)
        for name in ("state", "x_prev"):
            assert cache[name] is state[name]
            _close(cache[name], jcache[name])
        assert float(cache["state"].abs().max()) > 0
        want, jxp = cstep(jcm, jnp.asarray(x), jxp)
        got, xp = L.rwkv_ffn_apply(tcm, torch.from_numpy(x), cfg=cfg,
                                   x_prev=xp)
        _close(got, want)
        _close(xp, jxp)


@pytest.fixture(scope="module")
def lm_pair():
    jcfg, cfg = _configs()
    tree = _perturb(JLM(jcfg).init(jax.random.PRNGKey(5)), seed=6)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), params_from_jax(
        tree, cfg)


def test_stacked_state_decode_through_lm_apply(lm_pair):
    """The 2 layers are one scan stage: each step reads and writes the
    stacked caches through per-layer views. Logits and every stacked
    cache leaf equal to ``repro``'s after each of 8 steps."""
    jcfg, cfg, jparams, params = lm_pair
    jlm, lm = JLM(jcfg), LM(cfg)
    assert [(s.kind, s.repeats) for s in lm.stages] == [("scan", 2)]
    jcache = jlm.init_cache(3, 16, dtype=jnp.float32)
    cache = lm.init_cache(3, 16, dtype=torch.float32)
    step = jax.jit(lambda p, t, c: jlm.apply(p, t, mode="decode", cache=c))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (3, 8)).astype(np.int32)
    for i in range(8):
        want, jcache, _ = step(jparams, jnp.asarray(toks[:, i:i + 1]),
                               jcache)
        got, cache, _ = lm.apply(params, torch.from_numpy(toks[:, i:i + 1]),
                                 mode="decode", cache=cache)
        _close(got, want)
        block, jblock = cache["stages"][0][0], jcache["stages"][0][0]
        for t, j in ((block["mixer"]["state"], jblock["mixer"]["state"]),
                     (block["mixer"]["x_prev"], jblock["mixer"]["x_prev"]),
                     (block["ffn_x_prev"], jblock["ffn_x_prev"])):
            assert t.shape[0] == 2 and t.dtype == torch.float32
            _close(t, j)


def test_decode_from_zero_state_is_the_prefill(lm_pair):
    """Feeding 8 tokens one at a time through decode gives the logits the
    prefill gives at each of those positions."""
    _, cfg, _, params = lm_pair
    lm = LM(cfg)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    full, _, _ = lm.apply(params, toks)
    cache = lm.init_cache(2, 1, dtype=torch.float32)
    for i in range(8):
        got, cache, _ = lm.apply(params, toks[:, i:i + 1], mode="decode",
                                 cache=cache)
        _close(got[:, 0], full[:, i])
