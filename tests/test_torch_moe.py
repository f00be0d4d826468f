"""Parity of the port's MoE FFN (``repro_torch.models.layers`` ``moe_init``,
``moe_route``, ``moe_apply``) with the reference's
(``repro.models.layers.moe_apply``), on the CPU.

One MoE layer of 16 experts, top 4, d_model 128 and d_ff 64 (the reduced
qwen3-moe-30b-a3b's family with more experts), its weights from
``repro``'s ``moe_init`` (the norm weight perturbed), the same numpy
tokens in both packages; the reference's function is ``jax.jit``ed and run
once per case (a module fixture). Cases: the default capacity factor
1.25; 0.5, which forces drops; a decode-sized batch of 3 tokens (cap 1);
45 tokens in groups of 16 (2 groups of 22: one tail token, which gets no
MoE output); one shared expert. Levels: in f32 the experts chosen, each
pair's slot and the dropped pairs index-exact, ``y`` and ``aux`` within
2e-3; in bf16 ``y`` within 2e-2 relative, plus 2e-2 of y's RMS
absolute (the scale bf16 rounds at), on the tokens routed alike, and
``aux`` within 2e-2, every routing difference a near-tie (relative gap
2e-2 in probability) and every difference of slots or drops in a group
that has one. The
reference's routing is read by its own lines (``_jax_route``, copied
from ``repro/models/layers.py:513-533``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jL
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from test_torch_round import one_torch_thread  # noqa: F401

TOL = {"f32": 2e-3, "bf16": 2e-2}
NEAR_TIE = {"f32": 1e-3, "bf16": 2e-2}
MOE = dict(d_model=128, d_ff=64, num_experts=16, num_experts_per_tok=4)
# name -> (tokens (b, s), capacity_factor, group_size, shared experts)
CASES = {"default": ((2, 40), 1.25, 32, 0),
         "drops": ((2, 40), 0.5, 32, 0),
         "decode": ((3, 1), 1.25, 512, 0),
         "tail": ((3, 15), 1.25, 16, 0),
         "shared": ((2, 40), 1.25, 32, 1)}


def _configs(shared):
    changes = {**MOE, "num_shared_experts": shared}
    name = "qwen3-moe-30b-a3b"
    return (dataclasses.replace(jget_config(name).reduced(), **changes),
            dataclasses.replace(get_config(name).reduced(), **changes))


def _jax_route(p, x, *, cfg, capacity_factor, group_size):
    """The reference's routing lines of ``moe_apply`` -> (probs, topi,
    pos_in_e, keep), flattened over the groups."""
    d = x.shape[-1]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    xn = jL.rms_norm(x, p["norm"], cfg.norm_eps)
    flat = xn.reshape(-1, d)
    n = flat.shape[0]
    g = max(n // group_size, 1)
    gs = n // g
    flat = flat[: g * gs].reshape(g, gs, d)
    logits = flat @ p["router"]
    probs = jax.nn.softmax(logits.astype(jnp.float32), -1)
    topv, topi = jax.lax.top_k(probs, k)
    cap = max(int(gs * k / e * capacity_factor), 1)
    oh = jax.nn.one_hot(topi, e, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(oh.reshape(g, gs * k, e), 1).reshape(
        g, gs, k, e) - 1
    pos_in_e = (pos_in_e * oh).sum(-1)
    keep = pos_in_e < cap
    return (probs.reshape(-1, e), topi.reshape(-1, k),
            pos_in_e.reshape(-1, k), keep.reshape(-1, k))


def _case(name, dtype):
    (b, s), cf, group, shared = CASES[name]
    jcfg, cfg = _configs(shared)
    tree = jax.tree.map(np.asarray, jL.moe_init(jax.random.PRNGKey(3), jcfg))
    r = np.random.default_rng(4)
    tree["norm"] = tree["norm"] + 0.1 * r.normal(
        size=tree["norm"].shape).astype(np.float32)
    x = r.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in tree.items()}
    jx = jnp.asarray(x).astype(jdt)
    kw = dict(cfg=jcfg, capacity_factor=cf, group_size=group)
    y, aux = jax.jit(functools.partial(jL.moe_apply, **kw))(jp, jx)
    route = jax.jit(functools.partial(_jax_route, **kw))(jp, jx)
    want = {"y": np.asarray(y.astype(jnp.float32)), "aux": float(aux),
            "route": [np.asarray(a) for a in route]}
    p = {k: torch.from_numpy(np.array(v)).to(tdt) for k, v in tree.items()}
    xt = torch.from_numpy(x).to(tdt)
    return cfg, cf, group, p, xt, want


@pytest.fixture(scope="module", params=sorted(CASES))
def f32_case(request):
    return _case(request.param, "f32")


def _port(cfg, cf, group, p, x):
    y, aux = L.moe_apply(p, x, cfg=cfg, capacity_factor=cf,
                         group_size=group)
    xn = L.rms_norm(x, p["norm"], cfg.norm_eps).reshape(-1, cfg.d_model)
    route = L.moe_route(p, xn, cfg=cfg, capacity_factor=cf,
                        group_size=group)
    return y, aux, route


def test_moe_routing_slots_and_drops_are_index_exact_in_f32(f32_case):
    cfg, cf, group, p, x, want = f32_case
    _, _, r = _port(cfg, cf, group, p, x)
    jprobs, jtopi, jpos, jkeep = want["route"]
    np.testing.assert_allclose(r.probs.numpy(), jprobs, rtol=TOL["f32"],
                               atol=TOL["f32"])
    np.testing.assert_array_equal(r.topi.numpy(), jtopi)
    np.testing.assert_array_equal(r.pos.numpy(), jpos)
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)
    n = x.shape[0] * x.shape[1]
    assert r.groups * r.group_len == jtopi.shape[0] <= n


def test_moe_output_and_aux_match_in_f32(f32_case):
    cfg, cf, group, p, x, want = f32_case
    y, aux, _ = _port(cfg, cf, group, p, x)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want["y"], rtol=TOL["f32"],
                               atol=TOL["f32"])
    np.testing.assert_allclose(float(aux), want["aux"], rtol=TOL["f32"],
                               atol=TOL["f32"])


def test_the_cases_exercise_what_they_name():
    """drops drops pairs, decode has cap 1, tail leaves its last token
    without MoE output (as the reference's y), default has 2 groups of 40
    and cap 12, shared adds the ws_* leaves."""
    for name, check in [
            ("drops", lambda r, y, w: (~r.keep).sum() > 0),
            ("decode", lambda r, y, w: r.cap == 1 and r.group_len == 3),
            ("tail", lambda r, y, w: r.groups * r.group_len == 44
             and not y.reshape(-1, y.shape[-1])[44:].any()
             and not w["y"].reshape(-1, y.shape[-1])[44:].any()),
            ("default", lambda r, y, w: r.cap == 12 and r.groups == 2)]:
        cfg, cf, group, p, x, want = _case(name, "f32")
        y, _, r = _port(cfg, cf, group, p, x)
        assert check(r, y, want), name
    cfg, _, _, p, _, _ = _case("shared", "f32")
    assert {"ws_gate", "ws_up", "ws_down"} <= set(p)


@pytest.mark.parametrize("name", ["default", "drops"])
def test_moe_matches_in_bf16_up_to_near_ties(name):
    cfg, cf, group, p, x, want = _case(name, "bf16")
    y, aux, r = _port(cfg, cf, group, p, x)
    assert y.dtype == torch.bfloat16
    jprobs, jtopi, jpos, jkeep = want["route"]
    topi, keep = r.topi.numpy(), r.keep.numpy()
    probs = r.probs.numpy()
    for t, j in zip(*np.nonzero(topi != jtopi)):
        a, b = probs[t, topi[t, j]], probs[t, jtopi[t, j]]
        assert abs(a - b) <= NEAR_TIE["bf16"] * max(abs(a), abs(b)), (t, j)
    # slots and drops differ only in a group where the choices differ
    group_of = np.arange(topi.shape[0]) // r.group_len
    moved = set(group_of[(topi != jtopi).any(1)])
    assert set(group_of[((r.pos.numpy() != jpos)
                         | (keep != jkeep)).any(1)]) <= moved
    alike = ((topi == jtopi) & (keep == jkeep)).all(1)
    got = y.to(torch.float32).reshape(-1, y.shape[-1]).numpy()
    ref = want["y"].reshape(-1, y.shape[-1])
    # each bf16 product and sum rounds at the scale of its terms (y's
    # scale, ~5 here), not at that of a small result: the absolute part of
    # the level is 2e-2 of y's RMS (each package's run lies up to ~0.08
    # from the f64 result of the same bf16 values, both alike)
    scale = float(np.sqrt(np.mean(ref ** 2)))
    np.testing.assert_allclose(got[:len(alike)][alike],
                               ref[:len(alike)][alike], rtol=TOL["bf16"],
                               atol=TOL["bf16"] * scale)
    np.testing.assert_allclose(float(aux), want["aux"], rtol=TOL["bf16"],
                               atol=TOL["bf16"])


def test_top_k_breaks_ties_toward_the_lower_expert():
    """A zero router makes every probability equal: both packages pick
    experts 0..k-1 for every token, in that order (``jax.lax.top_k``'s
    order, which the port's stable descending sort keeps), and the top-1
    counts of the aux term follow."""
    jcfg, cfg = _configs(0)
    tree = jax.tree.map(np.asarray, jL.moe_init(jax.random.PRNGKey(5), jcfg))
    tree["router"] = np.zeros_like(tree["router"])
    x = np.random.default_rng(6).normal(size=(1, 24, cfg.d_model)).astype(
        np.float32)
    kw = dict(cfg=jcfg, capacity_factor=1.25, group_size=512)
    _, jtopi, _, _ = jax.jit(functools.partial(_jax_route, **kw))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    p = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    xn = L.rms_norm(torch.from_numpy(x), p["norm"]).reshape(-1, cfg.d_model)
    r = L.moe_route(p, xn, cfg=cfg)
    k = cfg.num_experts_per_tok
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(jtopi))
    assert (r.topi == torch.arange(k)).all()
    _, aux = L.moe_apply(p, torch.from_numpy(x), cfg=cfg)
    _, jaux = jax.jit(functools.partial(jL.moe_apply, cfg=jcfg))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL["f32"],
                               atol=TOL["f32"])


def test_moe_init_has_the_references_leaves():
    for shared in (0, 1):
        jcfg, cfg = _configs(shared)
        want = jax.eval_shape(lambda k: jL.moe_init(k, jcfg),
                              jax.random.PRNGKey(0))
        got = L.moe_init(L.ParamInit(None, "meta"), cfg)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}


def test_moe_drops_the_references_pairs_and_zeroes_their_terms():
    """At capacity factor 0.5 the port drops as many (token, choice) pairs
    as the reference, and a dropped pair adds nothing to ``y``: a token's
    output is the weighted sum of its kept choices' expert outputs."""
    cfg, cf, group, p, x, want = _case("drops", "f32")
    y, _, r = _port(cfg, cf, group, p, x)
    jkeep = want["route"][3]
    assert int((~r.keep).sum()) == int((~jkeep).sum()) > 0
    xn = L.rms_norm(x, p["norm"], cfg.norm_eps).reshape(-1, cfg.d_model)
    act = L.act_fn(cfg.act)
    flat = y.reshape(-1, cfg.d_model)
    for t in torch.nonzero((~r.keep).any(1))[:4, 0].tolist():
        terms = [r.topv[t, j] * (act(xn[t] @ p["we_gate"][ei])
                                 * (xn[t] @ p["we_up"][ei])) @ p["we_down"][ei]
                 for j, ei in enumerate(r.topi[t].tolist()) if r.keep[t, j]]
        expect = sum(terms) if terms else torch.zeros(cfg.d_model)
        np.testing.assert_allclose(flat[t].numpy(), expect.numpy(),
                                   rtol=TOL["f32"], atol=TOL["f32"])
