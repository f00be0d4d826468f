"""Parity of the port's Mamba (``repro_torch.models.layers``
``_selective_scan``, ``mamba_init``, ``mamba_cache_init``, ``mamba_apply``)
and of jamba's LM with the reference's (``repro``), on the CPU.

The selective scan on numpy inputs (u, B, C ~ N(0,1), dt = softplus of
N(0,1) - 1, A = -exp of N(0,1), D ~ N(0,1)) at s = 1, 7, 255 and 300 (one
chunk), 256, 512 and 768 (whole chunks of 256: the state carried from
chunk to chunk); s = 513, which the reference's chunking cannot reshape,
raises ``ValueError`` in the port (and fails in the reference). One Mamba
layer of jamba's reduced family (d_model 128, d_inner 256, state 16,
conv width 4), its weights from ``repro``'s init with every per-channel
vector perturbed, in prefill at S = 64 and 300 and over 6 decode steps
at batch 3 (outputs and the new conv and SSM states within 2e-3 at
every step, written into the caller's tensors); its decode steps from a
zero state equal its prefill at those positions. Jamba's reduced LM cut
to the card's unit (mamba, mamba, mamba, attn; MoE on layers 1 and 3) at
8 layers, one scan stage of 2: full-mode logits, 8 teacher-forced decode
steps (logits and every stacked state), greedy tokens, and (without the
MoE) decode from a zero cache against the prefill. Level: 2e-3, f32. One
reference LM is shared by the module's tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import make_decode_step as jmake_decode
from repro.models import layers as jL
from repro.models.transformer import LM as JLM
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import layers as L
from repro_torch.models.transformer import LM, params_from_jax
from test_torch_round import one_torch_thread  # noqa: F401

TOL = 2e-3
ARCH = "jamba-1.5-large-398b"


def _configs(**changes):
    return (dataclasses.replace(jget_config(ARCH).reduced(), **changes),
            dataclasses.replace(get_config(ARCH).reduced(), **changes))


def _perturb(tree, seed):
    """Norm weights 1 + 0.1 N(0,1); Mamba's conv bias, dt bias and skip D
    shifted by 0.1 N(0,1) and its A_log by 0.2 N(0,1), from numpy."""
    r = np.random.default_rng(seed)

    def f(path, x):
        name = str(getattr(path[-1], "key", ""))
        noise = r.normal(size=x.shape).astype(np.float32)
        if "norm" in name or name in ("conv_b", "dt_bias", "D"):
            return x + 0.1 * noise
        if name == "A_log":
            return x + 0.2 * noise
        return x
    return jax.tree_util.tree_map_with_path(f, jax.tree.map(np.asarray,
                                                            tree))


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _scan_inputs(s, seed):
    r = np.random.default_rng(seed)
    b, di, st = 2, 16, 4
    u = r.normal(size=(b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(b, s, di)) - 1.0)).astype(
        np.float32)
    a = -np.exp(r.normal(size=(di, st))).astype(np.float32)
    bb, cc = (r.normal(size=(b, s, st)).astype(np.float32)
              for _ in range(2))
    d = r.normal(size=(di,)).astype(np.float32)
    return u, dt, a, bb, cc, d


@pytest.mark.parametrize("s", [1, 7, 255, 256, 300, 512, 768])
def test_selective_scan_matches(s):
    ins = _scan_inputs(s, s)
    want = jax.jit(jL._selective_scan)(*map(jnp.asarray, ins))
    got = L._selective_scan(*map(torch.from_numpy, ins))
    assert got.shape == (2, s, 16) and got.dtype == torch.float32
    _close(got, want)


def test_selective_scan_refuses_a_length_the_reference_cannot_run():
    """s = 513 is two chunks of 256 and one token over: the reference's
    reshape fails, the port names the length."""
    ins = _scan_inputs(513, 1)
    with pytest.raises(ValueError, match="513"):
        L._selective_scan(*map(torch.from_numpy, ins))
    with pytest.raises(TypeError):
        jL._selective_scan(*map(jnp.asarray, ins))


def test_mamba_init_and_cache_have_the_references_leaves():
    jcfg, cfg = _configs()
    want = jL.mamba_init(jax.random.PRNGKey(0), jcfg)
    got = L.mamba_init(L.ParamInit(None, "meta"), cfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    real = L.mamba_init(L.ParamInit(torch.Generator()), cfg)
    np.testing.assert_allclose(real["A_log"].numpy(),
                               np.asarray(want["A_log"]), rtol=1e-6)
    jc, c = jL.mamba_cache_init(jcfg, 3), L.mamba_cache_init(cfg, 3)
    for k in ("conv", "ssm"):
        assert tuple(c[k].shape) == jc[k].shape
        assert c[k].dtype == torch.float32 and jc[k].dtype == jnp.float32


def _layer(jcfg, seed):
    return _perturb(jL.mamba_init(jax.random.PRNGKey(seed), jcfg), seed)


@pytest.mark.parametrize("s", [64, 300])
def test_mamba_prefill_matches(s):
    jcfg, cfg = _configs()
    p = _layer(jcfg, seed=1)
    x = np.random.default_rng(2).normal(size=(2, s, cfg.d_model)).astype(
        np.float32)
    want, _ = jax.jit(lambda p, x: jL.mamba_apply(p, x, cfg=jcfg,
                                                  mode="full"))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got, cache = L.mamba_apply(_torch(p), torch.from_numpy(x), cfg=cfg,
                               mode="full")
    assert cache is None
    _close(got, want)


def test_mamba_decode_matches():
    """6 steps at batch 3 from a zero state: y and the conv and SSM states
    within 2e-3 at every step, written into the caller's tensors."""
    jcfg, cfg = _configs()
    p = _layer(jcfg, seed=3)
    jp, tp = jax.tree.map(jnp.asarray, p), _torch(p)
    step = jax.jit(lambda p, x, c: jL.mamba_apply(p, x, cfg=jcfg,
                                                  mode="decode", cache=c))
    jcache = jL.mamba_cache_init(jcfg, 3)
    cache = L.mamba_cache_init(cfg, 3)
    held = dict(cache)
    xs = np.random.default_rng(4).normal(size=(3, 6, cfg.d_model)).astype(
        np.float32)
    for i in range(6):
        x = xs[:, i:i + 1]
        want, jcache = step(jp, jnp.asarray(x), jcache)
        got, cache = L.mamba_apply(tp, torch.from_numpy(x), cfg=cfg,
                                   mode="decode", cache=cache)
        _close(got, want)
        for name in ("conv", "ssm"):
            assert cache[name] is held[name]
            _close(cache[name], jcache[name])
    assert float(cache["ssm"].abs().max()) > 0


def test_mamba_decode_from_zero_state_is_the_prefill():
    jcfg, cfg = _configs()
    p = _torch(_layer(jcfg, seed=5))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 10, cfg.d_model)).astype(np.float32))
    full, _ = L.mamba_apply(p, x, cfg=cfg, mode="full")
    cache = L.mamba_cache_init(cfg, 2)
    for i in range(10):
        y, cache = L.mamba_apply(p, x[:, i:i + 1], cfg=cfg, mode="decode",
                                 cache=cache)
        _close(y[:, 0], full[:, i])


@pytest.fixture(scope="module")
def lm_pair():
    """Jamba's reduced family cut to the card's unit: 8 layers of (mamba,
    mamba, mamba, attn), the MoE on every second layer."""
    pattern = jget_config(ARCH).block_pattern[:4]
    jcfg, cfg = _configs(num_layers=8, block_pattern=pattern)
    tree = _perturb(JLM(jcfg).init(jax.random.PRNGKey(7)), seed=8)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), params_from_jax(
        tree, cfg)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_jamba_stages_are_the_references(lm_pair):
    jcfg, cfg, _, _ = lm_pair
    lm = LM(cfg)
    assert [(s.kind, s.repeats) for s in lm.stages] == [("scan", 2)]
    assert [(s.mixer, s.ffn) for s in lm.stages[0].unit] == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("attn", "moe")]
    assert [dataclasses.astuple(s) for s in lm.stages] == \
        [dataclasses.astuple(s) for s in JLM(jcfg).stages]


def test_jamba_full_logits_match(lm_pair):
    jcfg, cfg, jparams, params = lm_pair
    toks = _tokens(cfg.vocab_size, (2, 24), seed=9)
    want, _, jaux = jax.jit(lambda p, t: JLM(jcfg).apply(p, t))(
        jparams, jnp.asarray(toks))
    got, _, aux = LM(cfg).apply(params, torch.from_numpy(toks))
    _close(got, want)
    _close(aux, jaux)


def test_jamba_stacked_state_decode_through_lm_apply(lm_pair):
    """8 teacher-forced steps at batch 3 on a 6-slot ring: logits and
    every stacked Mamba state equal to ``repro``'s after each step (a
    state that was not written back would stay at zero)."""
    jcfg, cfg, jparams, params = lm_pair
    jlm, lm = JLM(jcfg), LM(cfg)
    jcache = jlm.init_cache(3, 6, dtype=jnp.float32)
    cache = lm.init_cache(3, 6, dtype=torch.float32)
    step = jax.jit(lambda p, t, c: jlm.apply(p, t, mode="decode", cache=c))
    toks = _tokens(cfg.vocab_size, (3, 8), seed=10)
    for i in range(8):
        want, jcache, _ = step(jparams, jnp.asarray(toks[:, i:i + 1]),
                               jcache)
        got, cache, _ = lm.apply(params, torch.from_numpy(toks[:, i:i + 1]),
                                 mode="decode", cache=cache)
        _close(got, want)
        for u in range(3):
            block, jblock = cache["stages"][0][u], jcache["stages"][0][u]
            for name in ("conv", "ssm"):
                t = block["mixer"][name]
                assert t.shape[0] == 2 and t.dtype == torch.float32
                _close(t, jblock["mixer"][name])
    assert float(cache["stages"][0][0]["mixer"]["ssm"].abs().max()) > 0


def test_jamba_greedy_decode_gives_the_same_tokens(lm_pair):
    jcfg, cfg, jparams, params = lm_pair
    jstep, jlm = jmake_decode(jcfg, dtype=jnp.float32)
    step, lm = make_decode_step(cfg, dtype=torch.float32)
    jcache = jlm.init_cache(2, 16, dtype=jnp.float32)
    cache = lm.init_cache(2, 16, dtype=torch.float32)
    jtok = jnp.asarray(_tokens(cfg.vocab_size, (2, 1), seed=11))
    tok = torch.from_numpy(np.array(jtok))
    jstep = jax.jit(jstep)
    for _ in range(6):
        jtok, jcache = jstep(jparams, jcache, jtok)
        tok, cache = step(params, cache, tok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_jamba_decode_from_zero_cache_is_the_prefill(lm_pair):
    """Without the MoE (whose capacity drops differ between a prefill's
    group of tokens and a decode step's): the Mamba states and the
    attention ring carry the prefix from step to step."""
    _, cfg, _, _ = lm_pair
    cfg = dataclasses.replace(cfg, num_experts=0, num_experts_per_tok=0)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(13))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 8), seed=12))
    full, _, _ = lm.apply(params, toks)
    cache = lm.init_cache(2, 8, dtype=torch.float32)
    for i in range(8):
        got, cache, _ = lm.apply(params, toks[:, i:i + 1], mode="decode",
                                 cache=cache)
        _close(got[:, 0], full[:, i])
