"""FSDP over "data": gloo worlds of 2 and 4 processes on the CPU
(``tests/torch_model_axis_worker.py``, spawned once each) run the port's
train, prefill and decode steps of reduced jamba-1.5-large-398b (cut to
its first 4 layers: Mamba, Mamba + MoE, Mamba, attention + MoE) and
deepseek-v2-236b (MLA with 4 heads; a dense layer, then an MoE layer
with a shared expert) on 2 x 1 and 2 x 2 meshes, their weights DTensors
on the plans with a second dim over "data" (``models/fsdp.py``: each
block's leaves gathered at its entry, the gradients reduce-scattered as
the mean over the data ranks, the leaves whole on every data rank
averaged), in f32, on the same numpy inputs and ``params_from_jax``
weights as the reference. The reduced archs lie far below
``sharding.FSDP_THRESHOLD``: each case carries a threshold of 0, which
the worker puts in the planner's place for that case only.

The train step runs G = 1 (the huge archs' fed layout on one pod), each
data rank 2 of a microbatch's 4 rows of 256 tokens (its MoE tokens in
whole groups of 512), with ``split_fl`` and one cluster a probe row.
Prefill and decode (10 teacher-forced steps over an 8-slot ring) split
their 2 rows over "data"; the MoE gathers them to route as one rank
(a row is no whole group).

Levels: every rank the same bits (so every data rank leaves the round
with the same weights: a replicated leaf whose gradient was not
averaged drifts); in f32 within 2e-3 of the reference's unsharded
``make_train_step``, ``make_prefill_step`` and ``make_decode_step``, and
W_G within rtol 1e-5 / atol 1e-6 of the port's one-rank step; prefill
and decode in f64 at that level of the port's one-rank steps in f64
(``torch_model_axis_families.check_serve``). phi3-medium-14b (reduced),
a dense arch, runs the train step and prefill on 2 x 2 past the same
threshold against its one-rank steps, and decodes there.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_model_axis as M
import torch_model_axis_families as F
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch.serve import cut_depth
from repro_torch.optim.optimizers import tree_leaves, tree_map
from test_torch_round import one_torch_thread  # noqa: F401
from torch_once import once

JAMBA, DEEPSEEK, PHI3 = ("jamba-1.5-large-398b", "deepseek-v2-236b",
                         "phi3-medium-14b")
ARCHS = (JAMBA, DEEPSEEK)
LAYERS = {JAMBA: 4, DEEPSEEK: 2, PHI3: 2}
TRAIN_T = 256                       # 2 rows a rank: 512 MoE tokens
MESHES = {"2x1": ((2, 1), 2), "2x2": ((2, 2), 4)}
STEPS = ("train", "prefill", "decode")


class CutPort(M.Port):
    """``Port`` of an arch cut to ``LAYERS`` deep (both packages'
    configs, ``cut_depth``), its train rows ``TRAIN_T`` tokens long."""

    def __init__(self, arch, seed):
        cfgs = M._cfgs
        M._cfgs = lambda a: tuple(cut_depth(c, LAYERS[a]) for c in cfgs(a))
        try:
            super().__init__(arch, seed, (1,))
        finally:
            M._cfgs = cfgs
        prefill, decode, _, key, first = self.inputs[1]
        rng = np.random.default_rng(seed + 7)
        train = {"tokens": rng.integers(
            0, self.cfg.vocab_size,
            (1, M.L_STEPS, 1, M.MB, TRAIN_T)).astype(np.int32)}
        self.inputs[1] = (prefill, decode, train, key, first)


def _fsdp(cases):
    return {k: dict(c, fsdp_threshold=0) for k, c in cases.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return once(tmp_path_factory, "fsdp_worlds",
                lambda: _worlds(tmp_path_factory.mktemp("fsdp")))


def _worlds(tmp):
    ports = {JAMBA: CutPort(JAMBA, 61), DEEPSEEK: CutPort(DEEPSEEK, 63)}
    phi3 = CutPort(PHI3, 65)
    jobs = {2: {}, 4: {}}
    for tag, (mesh, world) in MESHES.items():
        for arch, port in ports.items():
            jobs[world].update(_fsdp(F.serve_cases(
                port, f"{arch} {tag}", mesh,
                {"prefill": ("decode",), "decode": 1})))
            jobs[world].update(_fsdp(port.cases(f"{arch} {tag}", mesh, 1,
                                                {"train": 1})))
    # deepseek's prefill in the dry run's dtypes, for its count
    prefill = ports[DEEPSEEK].inputs[1][0]
    jobs[2][(f"{DEEPSEEK} 2x1 count", "prefill", "prefill")] = dict(
        kind="prefill", mesh=(2, 1), cfg=ports[DEEPSEEK].cfg,
        params=tree_map(lambda x: x.to(torch.bfloat16),
                        ports[DEEPSEEK].params),
        plan="prefill", batch=M._torch(prefill), dtype=torch.bfloat16,
        fsdp_threshold=0)
    jobs[4].update(_fsdp(phi3.cases(PHI3, (2, 2), 1, {
        "prefill": ("prefill",), "train": 1})))
    jobs[4].update(_fsdp(F.serve_cases(phi3, PHI3, (2, 2), {"decode": 1})))
    procs = {w: F._spawn(tmp, w, job) for w, job in jobs.items()}

    # meanwhile: the reference's unsharded steps, the port's one rank
    one, ref = {}, {}
    tcfg = TrainConfig(**F.TCFG)
    for arch, port in ports.items():
        for dtype in (torch.float32, torch.float64):
            one[(arch, dtype)] = F.one_rank_serve(port, dtype)
        one[(arch, "train")] = port.one_rank_train(1, tcfg)
        ref[arch] = F.reference_serve(port)
        ref[(arch, "train")] = F.reference_train(port, 1)
    one[PHI3] = {"train": phi3.one_rank_train(1, tcfg),
                 **F.one_rank_serve(phi3, torch.float32),
                 "decode64": F.one_rank_serve(phi3, torch.float64)[
                     "decode"]}
    return dict(outs=F.join(procs), one=one, ref=ref)


def _check(worlds, arch, tag, step):
    world = MESHES[tag][1]
    key = f"{arch} {tag}"
    if step == "train":
        runs = F.ranks(worlds["outs"], world, (key, "train"))
        (leaves, metrics), _ = runs[0]
        assert all(m == metrics for (_, m), _ in runs)
        assert metrics["selected"] == F.MB
        F.check_train((leaves, metrics), worlds["one"][(arch, "train")],
                      worlds["ref"][(arch, "train")])
        return
    plan = ("decode",) if step == "prefill" else ()
    runs = F.ranks(worlds["outs"], world, (key, step) + plan)
    runs64 = F.ranks(worlds["outs"], world, (key + " f64", step) + plan)
    F.check_serve(step, runs[0][0], runs64[0][0],
                  worlds["one"][(arch, torch.float32)][step],
                  worlds["one"][(arch, torch.float64)][step],
                  worlds["ref"][arch][step])


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_families_fsdp_on_a_model_axis(worlds, arch, step):
    """2 x 2: the weights split over "data" and "model" at once, each
    block gathered over "data" to the model-axis shard the layers take;
    the experts over "model", MLA's and the attention's heads too."""
    _check(worlds, arch, "2x2", step)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_on_the_data_axis(worlds, arch, step):
    """2 x 1: FSDP alone."""
    _check(worlds, arch, "2x1", step)


@pytest.mark.parametrize("step", STEPS)
def test_fsdp_past_the_threshold(worlds, step):
    """A dense arch past the threshold shards over "data" the same way:
    phi3-medium-14b's attention and FFN, embedding and head; its decode
    (a row a data rank) the tokens of one rank, the cache in f64 within
    rtol 1e-5 / atol 1e-6 of one rank's in f64."""
    key = {"prefill": (PHI3, "prefill", "prefill"),
           "train": (PHI3, "train"), "decode": (PHI3, "decode")}[step]
    runs = F.ranks(worlds["outs"], 4, key)
    got, heads = runs[0]
    want = worlds["one"][PHI3][step]
    if step == "prefill":
        M._one_rank_close(got, want)
    elif step == "train":
        F.check_train(got, want)
    else:
        (picked64, cache64), _ = F.ranks(worlds["outs"], 4,
                                         (PHI3 + " f64", "decode"))[0]
        want64 = worlds["one"][PHI3]["decode64"]
        assert torch.equal(got[0], want[0])
        assert torch.equal(picked64, want64[0])
        for a, b in zip(tree_leaves(cache64), tree_leaves(want64[1])):
            M._one_rank_close(a, b)
    assert heads == [2]                 # 4 heads over the model axis


@pytest.mark.parametrize("arch", ARCHS)
def test_the_plan_splits_every_big_leaf_over_data(arch, monkeypatch):
    """The plans the worlds run: past the threshold the train plan (G = 1
    on one pod, no fed axis) and decode's put a second dim of the
    experts, the projections, the embedding and the head on "data"; the
    norms and the router stay whole."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import fed_layout, step_plan
    monkeypatch.setattr(sh, "FSDP_THRESHOLD", 0)
    cfg = cut_depth(get_config(arch).reduced(), LAYERS[arch])
    axes = {"data": 2, "model": 2}
    assert fed_layout(cfg, axes) == (1, ())
    for kind in ("train", "decode"):
        plan = step_plan(cfg, axes, kind, g=1)
        specs = []
        sh.tree_map_specs(specs.append, plan.params)
        assert plan.notes == ["fsdp: second weight dim sharded over 'data'"]
        assert any("data" in s and "model" in s for s in specs)
        assert plan.params["embed"][-1] == "data"
        assert any("data" not in s for s in specs)     # norms, router


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def join(world, shape):
        from repro_torch.launch.mesh import PRODUCTION_AXES, mesh_over_world
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        return mesh_over_world(shape, PRODUCTION_AXES, "cpu")
    yield join
    dist.destroy_process_group()


def test_moe_rows_over_data_need_whole_groups(fake_world, monkeypatch):
    """A data rank's tokens of a microbatch must form whole groups of 512
    for the MoE to route as one rank: 2 rows of 16 tokens do not, and
    the step says so rather than compute another function."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.launch.specs import step_plan
    from repro_torch.launch.steps import make_train_step
    monkeypatch.setattr(sh, "FSDP_THRESHOLD", 0)
    mesh = fake_world(2, (2, 1))
    cfg = get_config(DEEPSEEK).reduced()
    tcfg = TrainConfig(**F.TCFG)
    step, lm = make_train_step(cfg, tcfg, mesh=mesh)
    params = lm.init(torch.Generator().manual_seed(0))
    params = distribute_tree(
        {k: v for k, v in _stack(params).items()},
        step_plan(cfg, {"data": 2, "model": 1}, "train", tcfg, lm, 1), mesh)
    tokens = torch.zeros((1, 1, 1, 4, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="whole groups of 512"):
        step(params, (), {"tokens": tokens}, [0])


def _stack(tree):
    from repro_torch.optim.optimizers import tree_map
    return tree_map(lambda x: x[None], tree)


def test_reduce_scatter_is_the_inverse_split_of_a_gather():
    """On meta tensors the reduce-scatter is charged, not sent: its chunk
    of the dim, and a dim the ranks do not divide raises."""
    from repro_torch.core.collectives import Ranks, reduce_scatter_cat
    from repro_torch.launch import flop_analysis
    x = torch.empty((6, 4), device="meta")
    with flop_analysis.counting() as c:
        out = reduce_scatter_cat(x, Ranks(None, 1, 3), 0)
    assert out.shape == (2, 4) and out.is_meta
    assert c.coll_bytes["reduce-scatter"] == 6 * 4 * 4
    with pytest.raises(ValueError, match="split"):
        reduce_scatter_cat(x, Ranks(None, 0, 4), 0)


def test_data_dims_read_the_placements(fake_world):
    """``fsdp.data_dims`` gives each leaf's dim on "data" from its DTensor
    placements, counted from its end (a stacked view reads the same), and
    None for a leaf replicated over "data" or a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models import fsdp
    mesh = fake_world(4, (2, 2))
    both = DTensor.from_local(torch.zeros(3, 2, 5), mesh,
                              (Shard(1), Shard(2)), run_check=False)
    model_only = DTensor.from_local(torch.zeros(4, 5), mesh,
                                    (Replicate(), Shard(1)),
                                    run_check=False)
    got = fsdp.data_dims({"a": both, "b": [model_only, torch.zeros(2)]},
                         mesh)
    assert got == {"a": -2, "b": [None, None]}
    x = torch.arange(12.0).reshape(3, 4)
    assert fsdp.gather_leaf(x, -1) is x          # outside ``over``


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_the_dry_run_counts_the_ranks_fsdp_collectives(worlds, kind,
                                                       monkeypatch):
    """With FSDP (the planner's threshold at 0, as the worker's cases
    put it) the dry run's count of each rank of deepseek's 2 x 1 (its
    bf16 prefill on prefill's plan, its f32 train round) equals, by
    kind, in count and bytes, the collectives that rank called: each
    block's gathers over "data", the gradients' reduce-scatters and the
    rows' gathers."""
    from repro_torch.launch import sharding
    monkeypatch.setattr(sharding, "FSDP_THRESHOLD", 0)
    key, shape, override = {
        "prefill": ((f"{DEEPSEEK} 2x1 count", "prefill", "prefill"),
                    "prefill_32k", {"seq_len": M.S, "global_batch": M.B}),
        "train": ((f"{DEEPSEEK} 2x1", "train"), "train_4k",
                  {"seq_len": TRAIN_T, "global_batch": M.MB})}[kind]
    for rank in range(2):
        F.check_collectives(worlds["outs"], 2, rank, key, DEEPSEEK, shape,
                            {"data": 2, "model": 1},
                            shape_override=override,
                            cfg_override={"num_layers": LAYERS[DEEPSEEK]},
                            tcfg=TrainConfig(**F.TCFG))
