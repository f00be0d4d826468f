"""Sequence-sharded activations in training (``TrainConfig.
seq_shard_activations``): gloo worlds of 2 and 4 processes on the CPU
(``tests/torch_model_axis_worker.py``, spawned once each) run the port's
train step with the hidden states between blocks split on the sequence
over "model" (Megatron's sequence parallelism, on the head-aware train
plan), in f32, on the same numpy inputs and ``params_from_jax`` weights as
the reference.

(a) The train step of reduced qwen3-moe-30b-a3b and deepseek-v2-236b
    (here; jamba-1.5-large-398b and rwkv6-3b in
    ``tests/test_torch_seq_shard_ssm.py``) on 1 x 2 and on 2 x 2 with
    FSDP (a threshold of 0, as ``tests/test_torch_fsdp.py``: "data"
    splits the cohort's rows and the weights' second dim, "model" the
    positions), G = 1, ``split_fl`` with one cluster a probe row,
    ``ROWS`` rows a microbatch, one local step; the MoE archs' rows
    ``T_MOE`` tokens long, so that each model rank's 512 positions of a
    row are a whole group of the route. W_G leaf by leaf and the metrics
    within 2e-3 of the reference's unsharded ``make_train_step`` and
    within rtol 1e-5 / atol 1e-6 of the port's one-rank step, every rank
    the same bits; the step reduce-scatters the blocks' row-parallel
    outputs, and the MoE archs' send their slots by an all-to-all.
    llama's (the dense family) on 1 x 2 and 2 x 2 with the cohorts over
    "data" is ``tests/test_torch_model_axis.py``.
(b) ``moe_apply`` (the reduced qwen3-moe's layer) on each rank's chunk of
    the positions on 1 x 2 and 1 x 4 against one rank's on them all: the
    output within rtol 1e-5 / atol 1e-6 (and 2e-3 of the reference's
    layer), the load-balance term within f32 rounding, the pairs kept
    by the ranks' routes together those of one rank's route; the layer
    calls ``collectives.all_to_all`` and no ``model_axis.reduce``. A
    chunk that is no whole number of groups raises ``ValueError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_model_axis as M
import torch_model_axis_families as F
from repro.configs import TrainConfig as JTrainConfig
from repro.launch.steps import make_train_step as jmake_train_step
from repro_torch.configs import TrainConfig
from repro_torch.core.collectives import Ranks
from repro_torch.launch.serve import cut_depth
from repro_torch.models import layers as L
from repro_torch.models import model_axis as MA
from test_torch_round import one_torch_thread  # noqa: F401
from torch_once import once

MOE, MLA, JAMBA = ("qwen3-moe-30b-a3b", "deepseek-v2-236b",
                   "jamba-1.5-large-398b")
ARCHS = (MOE, MLA)
ROWS, T_MOE, T = 2, 1024, 16        # a microbatch's rows and their length
TCFG = dict(dtype="float32", microbatch=ROWS, meta_clusters=ROWS)
# mesh -> its shape, world and what its cases carry
MESHES = {"1x2": ((1, 2), 2, {}), "2x2": ((2, 2), 4, {"fsdp_threshold": 0})}
LAYER_S = {2: 1024, 4: 2048}        # the MoE layer's positions on 1 x m


class SeqPort(M.Port):
    """``Port`` of an arch (jamba cut to 2 layers) whose train batch is
    (1, 1, 1, ``ROWS``, T) tokens, ``T_MOE`` long for an MoE arch, with
    the cohort's first centre drawn as the reference's step draws it."""

    def __init__(self, arch, seed):
        cfgs = M._cfgs
        if arch == JAMBA:
            M._cfgs = lambda a: tuple(cut_depth(c, 2) for c in cfgs(a))
        try:
            super().__init__(arch, seed, (1,))
        finally:
            M._cfgs = cfgs
        t = T_MOE if self.cfg.is_moe else T
        prefill, decode, _, _, _ = self.inputs[1]
        rng = np.random.default_rng(seed + 5)
        train = {"tokens": rng.integers(
            0, self.cfg.vocab_size, (1, 1, 1, ROWS, t)).astype(np.int32)}
        key = jax.random.PRNGKey(seed + 1)
        first = [int(jax.random.categorical(k, jnp.zeros(ROWS)))
                 for k in jax.random.split(key, 1)]
        self.inputs[1] = (prefill, decode, train, key, first)

    def reference_train(self):
        _, _, train, key, _ = self.inputs[1]
        tstep, _ = jmake_train_step(self.jcfg, JTrainConfig(**TCFG))
        jtp = jax.tree.map(lambda x: jnp.asarray(x)[None], self.jtrain_tree)
        new, _, metrics = jax.jit(tstep)(
            jtp, (), jax.tree.map(jnp.asarray, train), key)
        return ([np.asarray(x[0]) for x in jax.tree.leaves(new)],
                {k: float(v) for k, v in metrics.items()})


def spawn_train(tmp, archs, seed, extra=None):
    """Each arch's train cases on ``MESHES`` spawned (``extra``: more
    cases by world) -> (the spawned worlds, the ports)."""
    ports = {a: SeqPort(a, seed + 2 * i) for i, a in enumerate(archs)}
    tcfg = TrainConfig(**TCFG, seq_shard_activations=True)
    jobs = {2: {}, 4: {}}
    for arch, port in ports.items():
        for tag, (mesh, world, carry) in MESHES.items():
            jobs[world].update({k: dict(c, **carry) for k, c in port.cases(
                f"{arch} {tag}", mesh, 1, {"train": 1}, tcfg).items()})
    for world, cases in (extra or {}).items():
        jobs[world].update(cases)
    return {w: F._spawn(tmp, w, job) for w, job in jobs.items()}, ports


def train_runs(ports):
    """The port's one-rank and the reference's train steps of each arch
    -> ({arch: one rank's}, {arch: the reference's})."""
    return ({a: p.one_rank_train(1, TrainConfig(**TCFG))
             for a, p in ports.items()},
            {a: p.reference_train() for a, p in ports.items()})


def check_families(worlds, arch, mesh, moe):
    """An arch's sequence-split train step on ``mesh`` against one rank's
    and the reference's (``check_train``); the ranks reduce-scattered
    and (``moe``) sent slots by an all-to-all."""
    _, world, _ = MESHES[mesh]
    key = (f"{arch} {mesh}", "train")
    runs = F.ranks(worlds["outs"], world, key)
    (leaves, metrics), _ = runs[0]
    assert all(m == metrics for (_, m), _ in runs)
    assert metrics["selected"] == ROWS
    F.check_train((leaves, metrics), worlds["one"][arch],
                  worlds["ref"][arch])
    calls = [worlds["outs"][(world, r)][key + ("calls",)]
             for r in range(world)]
    assert all(c.get("reduce_scatter_cat", 0) > 0 for c in calls)
    assert all((c.get("all_to_all", 0) > 0) == moe for c in calls)


def _moe_layer():
    """The reduced qwen3-moe's MoE layer and an input of ``LAYER_S[m]``
    positions for each model axis m."""
    params, _ = F.layer_inputs("moe", 71)
    jcfg, _ = F.layer_configs("moe")
    rng = np.random.default_rng(72)
    xs = {m: rng.normal(size=(1, s, jcfg.d_model)).astype(np.float32)
          for m, s in LAYER_S.items()}
    return params, xs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return once(tmp_path_factory, "seq_shard_worlds",
                lambda: _worlds(tmp_path_factory))


def _worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_shard")
    params, xs = _moe_layer()
    procs, ports = spawn_train(tmp, ARCHS, 81, {m: {("moe seq", m): dict(
        F.layer_case("moe", (1, m), params, xs[m]), seq=True)}
        for m in LAYER_S})

    # meanwhile: the reference's unsharded steps and layer, the port's one
    # rank
    one, ref = train_runs(ports)
    _, cfg = F.layer_configs("moe")
    p = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    for m, x in xs.items():
        kept = []
        route = L.moe_route

        def seen(*args, **kwargs):
            r = route(*args, **kwargs)
            kept.append((int(r.keep.sum()), r.keep.numel()))
            return r
        L.moe_route = seen
        try:
            one[("moe", m)] = L.moe_apply(p, torch.from_numpy(x), cfg=cfg)
        finally:
            L.moe_route = route
        one[("moe kept", m)] = kept
        ref[("moe", m)] = F.reference_layer("moe", params, x)
    return dict(outs=F.join(procs), one=one, ref=ref)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_the_families_sequence_sharded_activations_match(worlds, arch,
                                                         mesh):
    check_families(worlds, arch, mesh, moe=True)


@pytest.mark.parametrize("m", sorted(LAYER_S))
def test_the_moe_routes_each_ranks_own_tokens(worlds, m):
    outs = worlds["outs"]
    runs = F.ranks(outs, m, ("moe seq", m))
    (y, aux), _ = runs[0]
    want, want_aux = worlds["one"][("moe", m)]
    M._one_rank_close(y, want)
    np.testing.assert_allclose(y.numpy(), worlds["ref"][("moe", m)][0],
                               rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=1e-7)
    # the pairs kept, summed over the ranks' routes, are one route's
    kept = [outs[(m, r)][("moe seq", m, "kept")] for r in range(m)]
    assert all(len(k) == 1 for k in kept)
    (one_kept, one_pairs), = worlds["one"][("moe kept", m)]
    assert sum(k[0][0] for k in kept) == one_kept
    assert sum(k[0][1] for k in kept) == one_pairs
    calls = [outs[(m, r)][("moe seq", m, "calls")] for r in range(m)]
    assert all(c.get("all_to_all", 0) == 2 and "reduce" not in c
               for c in calls)


def test_a_chunk_of_no_whole_groups_raises():
    _, cfg = F.layer_configs("moe")
    params, _ = F.layer_inputs("moe", 71)
    p = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    x = torch.zeros(2, 256, cfg.d_model)
    with MA.over(Ranks(None, 0, 2), seq=True):
        with pytest.raises(ValueError, match="whole groups of 512"):
            L.moe_apply(p, x, cfg=cfg)


def test_positions_that_do_not_split_raise():
    with MA.over(Ranks(None, 0, 2), seq=True):
        with pytest.raises(ValueError, match="do not split"):
            MA.seq_chunk(torch.zeros(1, 5, 4))


def test_the_dry_run_counts_a_sequence_sharded_pair():
    """``--seq-shard-acts``: the pair builds on the head-aware train plan
    and is counted as one rank runs it, its positions split over "model":
    at rows of 1,024 tokens a rank's 512 are a whole MoE group (at the
    smoke's 128 the rank's 64 are not, and the step refuses the pair, as
    ``test_a_chunk_of_no_whole_groups_raises``); the rank reduce-scatters
    its blocks' outputs and sends its slots by an all-to-all."""
    from repro_torch.launch import dryrun
    tcfg = TrainConfig(seq_shard_activations=True)
    rec = dryrun.run_one(MOE, "train_4k", smoke=True, verbose=False,
                         tcfg=tcfg, shape_override={"seq_len": 1024})
    assert rec["status"] == "ok", rec.get("error")
    assert rec["per_device_rule"] == "exact"
    assert rec["cost"]["flops"] > 0
    kinds = rec["collectives"]["count_by_kind"]
    assert kinds["reduce-scatter"] > 0 and kinds["all-to-all"] > 0
    short = dryrun.run_one(MOE, "train_4k", smoke=True, verbose=False,
                           tcfg=tcfg)
    assert short["status"] == "error" and "whole groups" in short["error"]


def test_the_split_is_off_outside_training():
    """Only the train step splits the sequence: ``over`` without ``seq``
    (prefill, decode, a ranked train step without the option) and one
    rank leave it off."""
    assert not MA.seq_split()
    with MA.over(Ranks(None, 0, 2)):
        assert not MA.seq_split()
    with MA.over(None, seq=True):
        assert not MA.seq_split()
    with MA.over(Ranks(None, 1, 2), seq=True):
        assert MA.seq_split()
    assert not MA.seq_split()
