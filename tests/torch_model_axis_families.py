"""What ``tests/test_torch_model_axis_moe_mla.py`` and
``tests/test_torch_model_axis_ssm.py`` share: the families' layers on
numpy inputs, the reference's unsharded layer, prefill and decode
functions on them (one ``jax.jit`` each, shared in a file), and the gloo
worlds (``tests/torch_model_axis_worker.py``) that run the port's
tensor-parallel layers and steps, spawned once a file.

A layer's weights are ``repro``'s init with every per-channel vector
perturbed (norms, RWKV's mixing coefficients, decay bias and bonus,
Mamba's conv bias, dt bias, skip and A_log: the init's are constants, so
a slice of the wrong channels would go unseen).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.launch.steps import make_decode_step as jmake_decode
from repro.launch.steps import make_prefill_step as jmake_prefill
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import layers as jL
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.optim.optimizers import tree_leaves, tree_map
from test_torch_model_axis import (B, MB, SLOTS, STEPS, TCFG, Port,
                                   _one_rank_close, _ref_close,
                                   _sorted_leaves, _spawn)

LAYER_S = 24                        # a layer's input (B, LAYER_S, d)
# layer -> (its init, the reduced arch it comes from)
LAYERS = {"moe": ("moe_init", "qwen3-moe-30b-a3b"),
          "mla": ("mla_init", "deepseek-v2-236b"),
          "mla_q_lora": ("mla_init", "deepseek-v2-236b"),
          "mamba": ("mamba_init", "jamba-1.5-large-398b"),
          "rwkv": ("rwkv_init", "rwkv6-3b"),
          "rwkv_ffn": ("rwkv_ffn_init", "rwkv6-3b")}


def layer_configs(layer):
    """(the reference's config, the port's) of a layer's reduced arch;
    ``mla_q_lora`` with a q LoRA of 24 (the reduced deepseek has none,
    the full one has)."""
    arch = LAYERS[layer][1]
    change = {"q_lora_rank": 24} if layer == "mla_q_lora" else {}
    return (dataclasses.replace(jget_config(arch).reduced(), **change),
            dataclasses.replace(get_config(arch).reduced(), **change))


def perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def one(name, x):
        noise = rng.normal(size=x.shape).astype(np.float32)
        if "norm" in name or name in ("ln_x", "conv_b", "dt_bias", "D"):
            return x + 0.1 * noise
        if name.startswith("mu_") or name == "A_log":
            return x + 0.2 * noise
        if name == "decay_bias":
            return x + noise
        if name == "bonus":
            return 0.5 * noise
        return x
    return {k: one(k, np.asarray(v)) for k, v in tree.items()}


def layer_inputs(layer, seed):
    """A layer's numpy weights and input (B, LAYER_S, d)."""
    jcfg, _ = layer_configs(layer)
    init = getattr(jL, LAYERS[layer][0])
    params = perturb(init(jax.random.PRNGKey(seed), jcfg), seed)
    x = np.random.default_rng(seed + 1).normal(
        size=(B, LAYER_S, jcfg.d_model)).astype(np.float32)
    return params, x


def reference_layer(layer, params, x):
    """The reference's layer on the same inputs -> its output (and the
    MoE's aux)."""
    jcfg, _ = layer_configs(layer)
    if layer == "moe":
        fn = functools.partial(jL.moe_apply, cfg=jcfg)
    elif layer == "rwkv_ffn":
        fn = lambda p, x: jL.rwkv_ffn_apply(p, x, cfg=jcfg)[0]  # noqa: E731
    else:
        name = "mla" if layer.startswith("mla") else layer
        apply = getattr(jL, f"{name}_apply")
        fn = lambda p, x: apply(p, x, cfg=jcfg, mode="full")[0]  # noqa
    out = jax.jit(fn)(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return jax.tree.map(np.asarray, out)


def layer_case(layer, mesh, params, x, head_aware=False):
    _, cfg = layer_configs(layer)
    name = "mla" if layer.startswith("mla") else layer
    return dict(kind="layer", mesh=mesh, cfg=cfg, layer=name,
                head_aware=head_aware,
                params={k: torch.from_numpy(np.array(v))
                        for k, v in params.items()},
                x=torch.from_numpy(x))


def reference_serve(port, g=1):
    """The reference's unsharded prefill logits and teacher-forced decode
    (tokens, cache leaves) on a port's inputs."""
    prefill, decode, _, _, _ = port.inputs[g]
    jp = jax.tree.map(jnp.asarray, port.jtree)
    pstep, _ = jmake_prefill(port.jcfg, dtype=jnp.float32)
    logits = np.asarray(jax.jit(pstep)(jp, jax.tree.map(jnp.asarray,
                                                        prefill)))
    dstep, jlm = jmake_decode(port.jcfg, dtype=jnp.float32)
    dstep = jax.jit(dstep)
    cache = jlm.init_cache(B, SLOTS, dtype=jnp.float32)
    picked = []
    for i in range(STEPS):
        nxt, cache = dstep(jp, cache, jnp.asarray(decode[:, i:i + 1]))
        picked.append(np.asarray(nxt))
    return dict(prefill=logits,
                decode=(np.concatenate(picked, 1),
                        [np.asarray(x) for x in jax.tree.leaves(cache)]))


def reference_train(port, g):
    """The reference's unsharded train step on a port's G-cohort inputs
    -> (the first cohort's new leaves, the metrics)."""
    _, _, train, key, _ = port.inputs[g]
    tstep, _ = jmake_train_step(port.jcfg, JTrainConfig(**TCFG))
    jtp = jax.tree.map(lambda x: jnp.broadcast_to(
        jnp.asarray(x)[None], (g,) + x.shape), port.jtrain_tree)
    new, _, metrics = jax.jit(tstep)(
        jtp, (), jax.tree.map(jnp.asarray, train), key)
    return ([np.asarray(x[0]) for x in jax.tree.leaves(new)],
            {k: float(v) for k, v in metrics.items()})


def absorbed(port):
    """The same weights and inputs with MLA's absorbed decode."""
    port.jcfg = dataclasses.replace(port.jcfg, mla_absorbed=True)
    port.cfg = dataclasses.replace(port.cfg, mla_absorbed=True)
    return port


def join(procs):
    """The spawned worlds' outputs by (world, rank); a rank's failure
    fails the fixture with its log."""
    outs = {}
    for world, ps in procs.items():
        for r, out, proc in ps:
            try:
                log, _ = proc.communicate(timeout=400)
            finally:
                proc.kill()
            assert proc.returncode == 0, \
                f"rank {r} of {world}:\n{log[-3000:]}"
            outs[(world, r)] = torch.load(out, weights_only=False)
    return outs


def ranks(outs, world, key):
    """Every rank's (result, heads seen) of one case, the results the
    same bits on every rank."""
    runs = [outs[(world, r)][key] for r in range(world)]
    first = tree_leaves(runs[0][0])
    for got, _ in runs[1:]:
        again = tree_leaves(got)
        assert len(again) == len(first)
        assert all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                   else a == b for a, b in zip(again, first))
    return runs


def serve_cases(port, tag, mesh, kinds):
    """A port's prefill and decode cases on ``mesh``, in f32 and again in
    f64 (keys ``tag`` and ``tag`` + " f64")."""
    out = port.cases(tag, mesh, 1, kinds)
    for key, case in port.cases(tag + " f64", mesh, 1, kinds).items():
        out[key] = dict(case, dtype=torch.float64, params=tree_map(
            lambda x: x.double(), case["params"]))
    return out


def one_rank_serve(port, dtype):
    """The port's one-rank prefill logits and teacher-forced decode
    (tokens, cache) in ``dtype`` (weights and cache cast to it)."""
    prefill, decode, _, _, _ = port.inputs[1]
    params = tree_map(lambda x: x.to(dtype), port.params)
    pstep, _ = make_prefill_step(port.cfg, dtype=dtype)
    logits = pstep(params, {k: torch.from_numpy(v)
                            for k, v in prefill.items()})
    dstep, lm = make_decode_step(port.cfg, dtype=dtype)
    cache = lm.init_cache(B, SLOTS, dtype=dtype)
    picked = []
    for i in range(STEPS):
        nxt, cache = dstep(params, cache,
                           torch.from_numpy(decode[:, i:i + 1]))
        picked.append(nxt)
    return dict(prefill=logits, decode=(torch.cat(picked, 1), cache))


def check_serve(kind, got, got64, one, one64, ref):
    """Prefill logits or decode (tokens, cache) on the model axis: in f32
    within 2e-3 of the reference (the tokens equal to the reference's and
    to the port's one rank's), and in f64 within rtol 1e-5 / atol 1e-6 of
    the port's one rank in f64 (in f32 the one-rank step itself is
    farther than that from its own f64 values on these models: that
    level reads the function in f64, rounding in f32)."""
    if kind == "prefill":
        _ref_close(got, ref)
        _one_rank_close(got64, one64)
        return
    (picked, cache), (picked64, cache64) = got, got64
    assert torch.equal(picked, one[0]) and torch.equal(picked64, one64[0])
    np.testing.assert_array_equal(picked.numpy(), ref[0])
    for a, b in zip(tree_leaves(cache64), tree_leaves(one64[1])):
        _one_rank_close(a, b)
    leaves = _sorted_leaves(cache)       # jax.tree.leaves' order
    assert len(leaves) == len(ref[1])
    for a, b in zip(leaves, ref[1]):
        _ref_close(a, b)


def check_train(got, one, ref=None):
    """W_G leaf by leaf and the metrics against the port's one rank (rtol
    1e-5 / atol 1e-6; the selection equal) and, where given, the
    reference (2e-3)."""
    leaves, metrics = got
    one_leaves, one_metrics = one
    assert metrics["selected"] == one_metrics["selected"]
    assert len(leaves) == len(one_leaves)
    for a, b in zip(leaves, one_leaves):
        _one_rank_close(a, b)
    for k in metrics:
        assert abs(metrics[k] - one_metrics[k]) <= 1e-5 * (
            1 + abs(one_metrics[k]))
    if ref is not None:
        ref_leaves, ref_metrics = ref
        assert len(ref_leaves) == len(leaves)
        for a, b in zip(leaves, ref_leaves):
            _ref_close(a, b)
        for k in metrics:
            np.testing.assert_allclose(metrics[k], ref_metrics[k],
                                       rtol=2e-3, atol=2e-3)


def check_collectives(outs, world, rank, key, arch, shape, axes, **run_kw):
    """The dry run's count of the rank at ``rank``'s coordinate on a mesh
    of ``axes`` (``dryrun.run_one(..., smoke=True, **run_kw)``) against
    the collectives that rank called in case ``key``'s first step call:
    by kind, in count and bytes."""
    from repro_torch.launch import dryrun
    coord = dict(zip(axes, (int(i) for i in np.unravel_index(
        rank, tuple(axes.values())))))
    rec = dryrun.run_one(arch, shape, smoke=True, verbose=False, axes=axes,
                         coord=coord, **run_kw)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["rank_coord"] == coord
    got = outs[(world, rank)][key + ("collectives",)]
    assert got, "the rank called no collective"
    assert rec["collectives"]["count_by_kind"] == {
        k: n for k, (n, _) in got.items()}
    assert rec["collectives"]["bytes_by_kind"] == {
        k: b for k, (_, b) in got.items()}
