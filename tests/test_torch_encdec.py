"""Parity of the port's encoder, cross-attention and vision prefix
(``repro_torch.models``: ``sinusoidal_pos``, ``attn_init(cross=True)``,
``attn_apply(enc_out=...)``, ``LM.encode``, ``LM.apply(enc_frames=...,
prefix_embeds=...)``, ``launch.steps.make_prefill_step``) with the
reference's (``repro``), on the CPU.

``sinusoidal_pos`` at whisper's width over the encoder's 1,500 positions
and at decode positions (B, 1) inside the decoder's 448. One
cross-attention block of whisper's reduced family (d_model 128, 4 / 2 heads of 32), its weights from
``repro``'s init with the norms perturbed, in full mode (12 decoder
queries over 16 encoder rows) and over 6 decode steps at batch 3 on a
4-slot ring that wraps; its decode steps from a zero cache equal its full
mode. Whisper's reduced LM (2 encoder and 2 decoder layers, 16 frames,
gelu, tied head, sinusoidal positions) and internvl2's (2 layers, 8
prefix embeddings through ``proj``), one reference LM each, shared by
the module's tests: the stage lists, ``LM.encode``, the full-mode logits
at every position (with ``enc_frames`` / ``prefix_embeds``), the prefill
step's last-position logits, 8 teacher-forced decode steps (whisper's
``enc_out`` in the cache) and 6 greedy tokens; whisper's decode from a
zero cache equals its full mode. Inputs from numpy seeds. Level: 2e-3,
f32; greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import make_decode_step as jmake_decode
from repro.launch.steps import make_prefill_step as jmake_prefill
from repro.models import layers as jL
from repro.models.transformer import LM as JLM
from repro.models.transformer import sinusoidal_pos as jsinusoidal_pos
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import layers as L
from repro_torch.models.transformer import (LM, params_from_jax,
                                            sinusoidal_pos)
from test_torch_round import one_torch_thread  # noqa: F401

TOL = 2e-3
WHISPER, INTERNVL = "whisper-medium", "internvl2-26b"


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _perturb(tree, seed):
    """Norm weights 1 + 0.1 N(0,1), from numpy."""
    r = np.random.default_rng(seed)

    def f(path, x):
        name = str(getattr(path[-1], "key", ""))
        if "norm" in name:
            return x + 0.1 * r.normal(size=x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, jax.tree.map(np.asarray,
                                                            tree))


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_sinusoidal_pos_matches():
    """Within 2e-3: the angles reach 1,500 radians, where one ulp of a
    frequency moves the sine by ~1e-4."""
    _close(sinusoidal_pos(1024, torch.arange(1500)),
           jsinusoidal_pos(1024, jnp.arange(1500)))
    pos = np.array([[0], [7], [447]], np.int32)
    got = sinusoidal_pos(128, torch.from_numpy(pos))
    assert got.shape == (3, 1, 128) and got.dtype == torch.float32
    _close(got, jsinusoidal_pos(128, jnp.asarray(pos)))


def _whisper_cfgs():
    return jget_config(WHISPER).reduced(), get_config(WHISPER).reduced()


def test_cross_attention_init_has_the_references_leaves():
    jcfg, cfg = _whisper_cfgs()
    want = jL.attn_init(jax.random.PRNGKey(0), jcfg, cross=True)
    got = L.attn_init(L.ParamInit(None, "meta"), cfg, cross=True)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert set(want) - set(L.attn_init(L.ParamInit(None, "meta"), cfg)) \
        == {"cross_norm", "cwq", "cwk", "cwv", "cwo"}


def _block(jcfg, seed):
    tree = _perturb(jL.attn_init(jax.random.PRNGKey(seed), jcfg,
                                 cross=True), seed)
    return (jax.tree.map(jnp.asarray, tree),
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def test_cross_attention_block_matches_in_full_mode():
    jcfg, cfg = _whisper_cfgs()
    jp, p = _block(jcfg, seed=1)
    x, enc = _normal((2, 12, cfg.d_model), 2), _normal((2, 16, cfg.d_model),
                                                       3)
    want, _ = jax.jit(lambda p, x, e: jL.attn_apply(
        p, x, cfg=jcfg, mode="full", enc_out=e))(jp, jnp.asarray(x),
                                                  jnp.asarray(enc))
    got, cache = L.attn_apply(p, torch.from_numpy(x), cfg=cfg, mode="full",
                              enc_out=torch.from_numpy(enc))
    assert cache is None
    _close(got, want)


def test_cross_attention_block_matches_in_decode():
    """6 steps at batch 3 on a 4-slot ring (it wraps), the same encoder
    rows every step: y and the ring within 2e-3 at every step."""
    jcfg, cfg = _whisper_cfgs()
    jp, p = _block(jcfg, seed=4)
    enc = _normal((3, 16, cfg.d_model), 5)
    xs = _normal((3, 6, cfg.d_model), 6)
    step = jax.jit(lambda p, x, c, pos, e: jL.attn_apply(
        p, x, cfg=jcfg, mode="decode", cache=c, pos=pos, enc_out=e))
    jcache = jL.attn_cache_init(jcfg, 3, 4, 0, jnp.float32)
    cache = L.attn_cache_init(cfg, 3, 4, 0, torch.float32)
    for i in range(6):
        pos = np.full((3,), i, np.int32)
        want, jcache = step(jp, jnp.asarray(xs[:, i:i + 1]), jcache,
                            jnp.asarray(pos), jnp.asarray(enc))
        got, cache = L.attn_apply(p, torch.from_numpy(xs[:, i:i + 1]),
                                  cfg=cfg, mode="decode", cache=cache,
                                  pos=torch.from_numpy(pos),
                                  enc_out=torch.from_numpy(enc))
        _close(got, want)
        _close(cache["k"], jcache["k"])


def test_cross_attention_decode_is_the_full_mode():
    _, cfg = _whisper_cfgs()
    p = L.attn_init(L.ParamInit(torch.Generator().manual_seed(7)), cfg,
                    cross=True)
    x = torch.from_numpy(_normal((2, 9, cfg.d_model), 8))
    enc = torch.from_numpy(_normal((2, 16, cfg.d_model), 9))
    full, _ = L.attn_apply(p, x, cfg=cfg, mode="full", enc_out=enc)
    cache = L.attn_cache_init(cfg, 2, 9, 0, torch.float32)
    for i in range(9):
        y, cache = L.attn_apply(p, x[:, i:i + 1], cfg=cfg, mode="decode",
                                cache=cache,
                                pos=torch.full((2,), i, dtype=torch.int32),
                                enc_out=enc)
        _close(y[:, 0], full[:, i])


@pytest.fixture(scope="module")
def whisper():
    jcfg, cfg = _whisper_cfgs()
    tree = _perturb(JLM(jcfg).init(jax.random.PRNGKey(10)), seed=11)
    frames = _normal((2, cfg.encoder_seq_len, cfg.d_model), 12)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg), frames)


def test_whisper_stages_are_the_references(whisper):
    jcfg, cfg, _, params, _ = whisper
    lm, jlm = LM(cfg), JLM(jcfg)
    for mine, theirs in ((lm.stages, jlm.stages),
                         (lm.enc_stages, jlm.enc_stages)):
        assert [dataclasses.astuple(s) for s in mine] == \
            [dataclasses.astuple(s) for s in theirs]
    assert {s.mixer for s in lm.specs} == {"attn_cross"}
    assert {(s.mixer, s.causal) for s in lm.enc_specs} == {("attn", False)}
    assert tuple(params["enc_norm"].shape) == (cfg.d_model,)
    assert "proj" not in params and "lm_head" not in params


def test_whisper_encode_matches(whisper):
    jcfg, _, jparams, params, frames = whisper
    want = jax.jit(lambda p, f: JLM(jcfg).encode(p, f))(
        jparams, jnp.asarray(frames))
    got = LM(whisper[1]).encode(params, torch.from_numpy(frames))
    assert got.shape == frames.shape
    _close(got, want)


def test_whisper_full_logits_match(whisper):
    jcfg, cfg, jparams, params, frames = whisper
    toks = _tokens(cfg.vocab_size, (2, 10), seed=13)
    want, _, _ = jax.jit(lambda p, t, f: JLM(jcfg).apply(
        p, t, enc_frames=f))(jparams, jnp.asarray(toks), jnp.asarray(frames))
    got, _, _ = LM(cfg).apply(params, torch.from_numpy(toks),
                              enc_frames=torch.from_numpy(frames))
    assert got.shape == (2, 10, cfg.padded_vocab)
    _close(got, want)
    with pytest.raises(ValueError, match="enc_frames"):
        LM(cfg).apply(params, torch.from_numpy(toks))


def test_whisper_prefill_step_matches(whisper):
    jcfg, cfg, jparams, params, frames = whisper
    toks = _tokens(cfg.vocab_size, (2, 10), seed=14)
    jstep, _ = jmake_prefill(jcfg, dtype=jnp.float32)
    step, _ = make_prefill_step(cfg, dtype=torch.float32)
    want = jax.jit(jstep)(jparams, {"tokens": jnp.asarray(toks),
                                    "enc_frames": jnp.asarray(frames)})
    got = step(params, {"tokens": torch.from_numpy(toks),
                        "enc_frames": torch.from_numpy(frames)})
    assert got.shape == (2, 1, cfg.padded_vocab)
    _close(got, want)


def _enc_caches(whisper, batch, slots):
    """Both packages' f32 caches with the reference's encoder output of
    the fixture's frames (one row per request)."""
    jcfg, cfg, jparams, _, frames = whisper
    enc = np.asarray(jax.jit(lambda p, f: JLM(jcfg).encode(p, f))(
        jparams, jnp.asarray(frames)))
    enc = np.concatenate([enc] * batch)[:batch]
    jcache = JLM(jcfg).init_cache(batch, slots, dtype=jnp.float32)
    jcache["enc_out"] = jnp.asarray(enc)
    cache = LM(cfg).init_cache(batch, slots, dtype=torch.float32)
    assert tuple(cache["enc_out"].shape) == enc.shape
    cache["enc_out"] = torch.from_numpy(enc)
    return jcache, cache


def test_whisper_decode_teacher_forced_logits_match(whisper):
    """8 steps at batch 3 on a 6-slot ring (it wraps), sinusoidal
    positions from the cache's ``pos``, cross-attention over the cache's
    ``enc_out``."""
    jcfg, cfg, jparams, params, _ = whisper
    jcache, cache = _enc_caches(whisper, 3, 6)
    jlm, lm = JLM(jcfg), LM(cfg)
    step = jax.jit(lambda p, t, c: jlm.apply(p, t, mode="decode", cache=c))
    toks = _tokens(cfg.vocab_size, (3, 8), seed=15)
    for i in range(8):
        want, jcache, _ = step(jparams, jnp.asarray(toks[:, i:i + 1]),
                               jcache)
        got, cache, _ = lm.apply(params, torch.from_numpy(toks[:, i:i + 1]),
                                 mode="decode", cache=cache)
        _close(got, want)


def test_whisper_greedy_decode_gives_the_same_tokens(whisper):
    jcfg, cfg, jparams, params, _ = whisper
    jstep, _ = jmake_decode(jcfg, dtype=jnp.float32)
    step, _ = make_decode_step(cfg, dtype=torch.float32)
    jcache, cache = _enc_caches(whisper, 2, 16)
    jtok = jnp.asarray(_tokens(cfg.vocab_size, (2, 1), seed=16))
    tok = torch.from_numpy(np.array(jtok))
    jstep = jax.jit(jstep)
    for _ in range(6):
        jtok, jcache = jstep(jparams, jcache, jtok)
        tok, cache = step(params, cache, tok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_whisper_decode_from_zero_cache_is_the_full_mode(whisper):
    _, cfg, _, params, frames = whisper
    lm = LM(cfg)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 8), seed=17))
    f = torch.from_numpy(frames)
    full, _, _ = lm.apply(params, toks, enc_frames=f)
    cache = lm.init_cache(2, 8, dtype=torch.float32)
    cache["enc_out"] = lm.encode(params, f)
    for i in range(8):
        got, cache, _ = lm.apply(params, toks[:, i:i + 1], mode="decode",
                                 cache=cache)
        _close(got[:, 0], full[:, i])


@pytest.fixture(scope="module")
def internvl():
    jcfg, cfg = jget_config(INTERNVL).reduced(), get_config(INTERNVL).reduced()
    tree = _perturb(JLM(jcfg).init(jax.random.PRNGKey(20)), seed=21)
    prefix = _normal((2, cfg.num_prefix_tokens, cfg.d_model), 22)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg), prefix)


def test_internvl2_full_logits_match_with_the_prefix(internvl):
    """P = 8 projected patches before 10 text tokens: 18 positions."""
    jcfg, cfg, jparams, params, prefix = internvl
    assert tuple(params["proj"].shape) == (cfg.d_model, cfg.d_model)
    toks = _tokens(cfg.vocab_size, (2, 10), seed=23)
    want, _, _ = jax.jit(lambda p, t, e: JLM(jcfg).apply(
        p, t, prefix_embeds=e))(jparams, jnp.asarray(toks),
                                jnp.asarray(prefix))
    got, _, _ = LM(cfg).apply(params, torch.from_numpy(toks),
                              prefix_embeds=torch.from_numpy(prefix))
    assert got.shape == (2, cfg.num_prefix_tokens + 10, cfg.padded_vocab)
    _close(got, want)


def test_internvl2_prefill_step_matches_with_the_prefix(internvl):
    jcfg, cfg, jparams, params, prefix = internvl
    toks = _tokens(cfg.vocab_size, (2, 10), seed=24)
    jstep, _ = jmake_prefill(jcfg, dtype=jnp.float32)
    step, _ = make_prefill_step(cfg, dtype=torch.float32)
    want = jax.jit(jstep)(jparams, {"tokens": jnp.asarray(toks),
                                    "prefix_embeds": jnp.asarray(prefix)})
    got = step(params, {"tokens": torch.from_numpy(toks),
                        "prefix_embeds": torch.from_numpy(prefix)})
    _close(got, want)


def test_internvl2_decode_teacher_forced_logits_match(internvl):
    jcfg, cfg, jparams, params, _ = internvl
    jlm, lm = JLM(jcfg), LM(cfg)
    jcache = jlm.init_cache(3, 6, dtype=jnp.float32)
    cache = lm.init_cache(3, 6, dtype=torch.float32)
    assert "enc_out" not in cache
    step = jax.jit(lambda p, t, c: jlm.apply(p, t, mode="decode", cache=c))
    toks = _tokens(cfg.vocab_size, (3, 8), seed=25)
    for i in range(8):
        want, jcache, _ = step(jparams, jnp.asarray(toks[:, i:i + 1]),
                               jcache)
        got, cache, _ = lm.apply(params, torch.from_numpy(toks[:, i:i + 1]),
                                 mode="decode", cache=cache)
        _close(got, want)


def test_internvl2_greedy_decode_gives_the_same_tokens(internvl):
    jcfg, cfg, jparams, params, _ = internvl
    jstep, jlm = jmake_decode(jcfg, dtype=jnp.float32)
    step, lm = make_decode_step(cfg, dtype=torch.float32)
    jcache = jlm.init_cache(2, 16, dtype=jnp.float32)
    cache = lm.init_cache(2, 16, dtype=torch.float32)
    jtok = jnp.asarray(_tokens(cfg.vocab_size, (2, 1), seed=26))
    tok = torch.from_numpy(np.array(jtok))
    jstep = jax.jit(jstep)
    for _ in range(6):
        jtok, jcache = jstep(jparams, jcache, jtok)
        tok, cache = step(params, cache, tok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
