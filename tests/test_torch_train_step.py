"""Parity of the port's federated LM train step with the reference's, on
the CPU.

``repro_torch.launch.steps.make_train_step`` against
``repro.launch.steps.make_train_step`` called without a mesh (``jax.jit``
of the step on one CPU device), on G = 2 stacked copies of ``repro``'s
parameters (``params_from_jax`` with the step's split stage list), the
same numpy tokens (G, L=2, n_micro=2, mb=4, T=16), f32 compute, and the
reference's K-means first centres: ``jax.random.categorical`` of each
cohort's key (``jax.random.split(key, G)``, as the step draws them), fed
in as row indices. Cases: ``split_fl`` on and off, ``fedavg_compress``
"" and "bf16", ``remat`` on and off (a 4-layer reduced llama3.2-1b, so
the split leaves two scan stages that remat checkpoints), and qwen2-0.5b
reduced with momentum and weight decay (a stacked optimizer state).
Level: loss, meta_loss, every new parameter (and momentum) within 2e-3;
``selected`` equal.

Each cohort selects as many clusters as its probe has rows: with fewer,
a 2-row cluster's centre is equidistant from its two rows and f32
rounding picks the representative (``ROADMAP.md`` Queue 3's exact ties),
so the two packages could meta-train on different rows. The selection
itself is held index-exact on structured maps by
``tests/test_torch_selection_paths.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.launch.steps import make_train_step as jmake_train_step
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import params_from_jax, tree_map
from test_torch_round import one_torch_thread  # noqa: F401

TOL = 2e-3
G, L, N_MICRO, MB, T = 2, 2, 2, 4, 16

# (arch, layers, TrainConfig changes)
CASES = {
    "split_fl": ("llama3.2-1b", 4, {}),
    "no_split_fl": ("llama3.2-1b", 4, {"split_fl": False}),
    "bf16_fedavg": ("llama3.2-1b", 4, {"fedavg_compress": "bf16"}),
    "no_remat": ("llama3.2-1b", 4, {"remat": False}),
    "momentum": ("qwen2-0.5b", None, {"momentum": 0.9,
                                      "weight_decay": 1e-3}),
}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_the_reference(case):
    arch, layers, changes = CASES[case]
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    knobs = dict(dtype="float32", microbatch=MB, meta_clusters=MB,
                 **changes)
    jstep, jlm = jmake_train_step(jcfg, JTrainConfig(**knobs))
    step, lm = make_train_step(cfg, TrainConfig(**knobs))
    if layers:
        assert all(st.kind == "scan" for st in lm.stages)

    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(1)))
    jparams = jax.tree.map(
        lambda x: jnp.broadcast_to(jnp.asarray(x)[None], (G,) + x.shape),
        tree)
    params = tree_map(lambda t: t[None].expand((G,) + tuple(t.shape)),
                      params_from_jax(tree, cfg, lm=lm))
    momentum = changes.get("momentum", 0.0)
    jstate = jax.tree.map(jnp.zeros_like, jparams) if momentum else ()
    state = tree_map(torch.zeros_like, params) if momentum else ()
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (G, L, N_MICRO, MB, T)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    first = [int(jax.random.categorical(k, jnp.zeros(MB)))
             for k in jax.random.split(key, G)]

    jnew, jstate, jm = jax.jit(jstep)(jparams, jstate,
                                      {"tokens": jnp.asarray(toks)}, key)
    new, state, m = step(params, state, {"tokens": torch.from_numpy(toks)},
                         first)

    assert sorted(m) == sorted(jm)
    for name in m:
        if name == "selected":
            assert float(m[name]) == float(jm[name])
        else:
            _close(m[name].numpy(), jm[name])
    got = jax.tree.leaves(tree_map(lambda t: t.numpy(), new))
    want = jax.tree.leaves(jnew)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b)
        assert np.array_equal(a[0], a[1])       # every cohort gets W_G(t)
    if momentum:
        for a, b in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(),
                                                 state)),
                        jax.tree.leaves(jstate)):
            _close(a, b)


def test_train_step_refuses_what_it_does_not_take():
    cfg = get_config("llama3.2-1b").reduced()
    step, lm = make_train_step(cfg, TrainConfig(dtype="float32"))
    params = tree_map(lambda t: t[None], lm.init(
        torch.Generator().manual_seed(0)))
    toks = torch.zeros((1, 1, 1, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="first centre"):
        step(params, (), {"tokens": toks})
    # the reference's extras are taken (tests/test_torch_train_extras.py);
    # any other batch key is refused
    with pytest.raises(ValueError, match="labels"):
        step(params, (), {"tokens": toks, "labels": toks}, [0])


def test_first_centres_may_come_from_a_generator():
    """A ``torch.Generator`` draws each cohort's first centre (what
    ``launch.train`` passes): the same seed gives the same round."""
    cfg = get_config("llama3.2-1b").reduced()
    step, lm = make_train_step(cfg, TrainConfig(dtype="float32",
                                                microbatch=4,
                                                meta_clusters=2))
    params = tree_map(lambda t: t[None].expand((2,) + tuple(t.shape)),
                      lm.init(torch.Generator().manual_seed(0)))
    toks = torch.randint(cfg.vocab_size, (2, 1, 1, 4, 8),
                         generator=torch.Generator().manual_seed(1))
    runs = [step(params, (), {"tokens": toks},
                 torch.Generator().manual_seed(5)) for _ in range(2)]
    for a, b in zip(*(jax.tree.leaves(tree_map(lambda t: t.numpy(), r[0]))
                      for r in runs)):
        assert np.array_equal(a, b)
