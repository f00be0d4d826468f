"""The model axis over ranks: gloo worlds of 2 and 4 processes on the CPU
(``tests/torch_model_axis_worker.py``, spawned once each with a
``file://`` init method) run the port's steps tensor parallel, their
weights DTensors on the steps' plans, and hand back what the steps
returned, gathered.

(a) Prefill and teacher-forced decode (10 steps over an 8-slot ring,
    which wraps) of a 4-layer reduced llama3.2-1b (4 heads, 2 kv heads,
    f32) on 1 x 2, prefill on both inference plans; both also on 2 x 2,
    where "data" splits the batch's rows.
(b) The train step with ``split_fl`` and one cluster a probe row, on 1 x 2
    (G = 1) and 2 x 2 (G = 2): the fed axis over "data", the model axis
    inside each cohort.
(c) 1 x 4, where the kv heads do not divide the axis: prefill on decode's
    plan (``wk`` and ``wv`` replicated, each rank slicing the kv head its
    one query head reads) and the train step on the train plan (the flat
    kv dim split mid-head, gathered to whole heads before the kernel).
    And 10 heads over 5 kv heads on 1 x 4 (prefill's plan and the train
    step's): each rank's columns split a query head, so it computes the
    heads they touch, 3 of them over 2 kv heads in no GQA order (the kv
    heads indexed a query head each), against the port's one-rank steps.

Levels: every rank the same bits; within f32 rounding of the port's
one-rank steps (rtol 1e-5, atol 1e-6; the tokens and the selection equal);
within 2e-3 of the reference's unsharded ``make_prefill_step``,
``make_decode_step`` and ``make_train_step`` on the same numpy inputs and
``params_from_jax`` weights (GSPMD's contract: a sharding is a layout). The
other dense families (qwen2-0.5b's biases, gemma3-4b's windows,
phi3-medium-14b, internvl2-26b's prefix, whisper-medium's encoder and
cross-attention; reduced) run prefill, decode and the train step on
1 x 2 against the port's one-rank steps, which their own test files hold
to the reference. Each rank records the query heads of its attention
calls: h / m of them.

(d) The train step with ``seq_shard_activations`` (the hidden states
    between blocks split on the sequence over "model") on 1 x 2 (G = 1)
    and 2 x 2 (G = 2), at (b)'s levels; its blocks' row-parallel outputs
    reduce-scattered. The other families' are
    ``tests/test_torch_seq_shard.py`` and
    ``tests/test_torch_seq_shard_ssm.py``.
(e) Inference over "pod" builds its steps and a cache on the mesh (the
    fake process group stands in for the ranks; gloo worlds run it in
    ``tests/test_torch_pods.py``); a DTensor reaching a kernel wrapper
    raises and names the wrapper. The
    MoE, MLA, Mamba and RWKV families on a model axis are
    ``tests/test_torch_model_axis_moe_mla.py`` and
    ``tests/test_torch_model_axis_ssm.py``, their heads that do not divide
    the axis ``tests/test_torch_frac_heads.py``; FSDP (jamba's,
    deepseek's and a dense arch's past the threshold) is
    ``tests/test_torch_fsdp.py``, a k/v or latent cache split on the head
    dim or the sequence ``tests/test_torch_seq_cache.py``;
    ``specs.params_on_mesh`` is held here to the distributed init.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.launch.steps import make_decode_step as jmake_decode
from repro.launch.steps import make_prefill_step as jmake_prefill
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.transformer import LM as JLM
from repro_torch.configs import TrainConfig, get_config
from repro_torch.core.fedavg import broadcast_to_clients
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (MULTI_POD_AXES, PRODUCTION_AXES,
                                     mesh_over_world)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.transformer import LM, params_from_jax
from repro_torch.optim.optimizers import tree_leaves, tree_map
from test_torch_round import one_torch_thread  # noqa: F401
from torch_once import once

TOL = 2e-3
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_model_axis_worker.py")
SRC = os.path.join(os.path.dirname(os.path.dirname(WORKER)), "src")
L_STEPS, MB, T = 2, 4, 16           # the train step: G x L x 1 x MB x T
B, S, SLOTS, STEPS = 2, 24, 8, 10   # prefill (B, S); decode B x STEPS
ODD = "10 heads"                    # over 5 kv heads, the reduced llama's
ARCHS = ["qwen2-0.5b", "gemma3-4b", "phi3-medium-14b", "internvl2-26b",
         "whisper-medium"]
TCFG = dict(dtype="float32", microbatch=MB, meta_clusters=MB)


def _cfgs(arch):
    if arch == ODD:
        jcfg, cfg = _cfgs("llama3.2-1b")
        return None, dataclasses.replace(cfg, num_heads=10, num_kv_heads=5)
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if arch == "llama3.2-1b":
        jcfg = dataclasses.replace(jcfg, num_layers=4)
        cfg = dataclasses.replace(cfg, num_layers=4)
    return jcfg, cfg


def _extras(cfg, lead, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        return {"enc_frames": rng.normal(size=lead + (
            cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        return {"prefix_embeds": rng.normal(size=lead + (
            cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)}
    return {}


def _inputs(cfg, g, seed):
    """numpy inputs: the prefill batch, the decode tokens, the train
    batch of G cohorts and its K-means key (its first centres drawn as
    the reference's step draws them)."""
    rng = np.random.default_rng(seed)
    prefill = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32), **_extras(cfg, (B,), seed + 1)}
    decode = rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    train = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (g, L_STEPS, 1, MB, T)).astype(np.int32),
             **_extras(cfg, (g, L_STEPS, 1, MB), seed + 2)}
    key = jax.random.PRNGKey(seed)
    first = [int(jax.random.categorical(k, jnp.zeros(MB)))
             for k in jax.random.split(key, g)]
    return prefill, decode, train, key, first


def _cat_rows(caches):
    """Decode caches of consecutive rows as one: the positions and each
    ring concatenated on their batch dim."""
    first = caches[0]
    if isinstance(first, dict):
        return {k: _cat_rows([c[k] for c in caches]) for k in first}
    if isinstance(first, list):
        return [_cat_rows([c[i] for c in caches]) for i in range(len(first))]
    return torch.cat(caches, first.ndim - 4 if first.ndim >= 4 else 0)


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


class Port:
    """One arch's port weights (from the reference's) and one-rank
    steps' results; ``train`` False leaves out the train step's weights
    (a port that only serves)."""

    def __init__(self, arch, seed, gs, train=True):
        self.jcfg, self.cfg = _cfgs(arch)
        cfg, tcfg = self.cfg, TrainConfig(**TCFG)
        self.train_lm = make_train_step(cfg, tcfg)[1]
        if self.jcfg is None:           # no reference config: torch draws
            gen = torch.Generator().manual_seed(seed)
            self.params = LM(cfg).init(gen)
            self.train_params = self.train_lm.init(gen)
        else:
            self.jtree = jax.tree.map(np.asarray, JLM(self.jcfg).init(
                jax.random.PRNGKey(seed)))
            self.params = params_from_jax(self.jtree, cfg)
        if self.jcfg is not None and train:
            _, jlm_split = jmake_train_step(self.jcfg, JTrainConfig(**TCFG))
            self.jtrain_tree = jax.tree.map(
                np.asarray, jlm_split.init(jax.random.PRNGKey(seed + 1)))
            self.train_params = params_from_jax(self.jtrain_tree, cfg,
                                                lm=self.train_lm)
        self.inputs = {g: _inputs(cfg, g, seed + 10 * g) for g in gs}

    def one_rank(self, g, data=1):
        """The port's one-rank prefill logits, decode tokens and cache,
        and train leaves and metrics, on the G-cohort inputs; prefill and
        decode a ``data`` axis's share of rows at a time, as the ranks
        split them (the products' bits depend on their row count: one row
        of decode is a matrix-vector product)."""
        cfg = self.cfg
        prefill, decode, train, _, first = self.inputs[g]
        pstep, _ = make_prefill_step(cfg, dtype=torch.float32)
        logits = torch.cat([pstep(self.params, _torch(
            {k: v[rows] for k, v in prefill.items()}))
            for rows in np.array_split(np.arange(B), data)])
        dstep, lm = make_decode_step(cfg, dtype=torch.float32)
        picked, caches = [], []
        for rows in np.split(decode, data):
            cache = lm.init_cache(len(rows), SLOTS, dtype=torch.float32)
            steps = []
            for i in range(STEPS):
                nxt, cache = dstep(self.params, cache,
                                   torch.from_numpy(rows[:, i:i + 1]))
                steps.append(nxt)
            picked.append(torch.cat(steps, 1))
            caches.append(cache)
        picked = torch.cat(picked, 0)
        cache = _cat_rows(caches)
        return dict(prefill=logits, decode=(picked, cache),
                    train=self.one_rank_train(g, TrainConfig(**TCFG)))

    def one_rank_train(self, g, tcfg):
        """The port's one-rank train step -> (the first cohort's new
        leaves, then its momentum's if any; the metrics)."""
        _, _, train, _, first = self.inputs[g]
        step, _ = make_train_step(self.cfg, tcfg)
        params = broadcast_to_clients(self.train_params, g)
        state = (tree_map(torch.zeros_like, params) if tcfg.momentum
                 else ())
        new, new_s, metrics = step(params, state, _torch(train), first)
        return ([x[0] for x in tree_leaves((new, new_s))],
                {k: float(v) for k, v in metrics.items()})

    def reference(self, g):
        """The reference's unsharded steps on the same inputs."""
        prefill, decode, train, key, _ = self.inputs[g]
        jstep, _ = jmake_prefill(self.jcfg, dtype=jnp.float32)
        jp = jax.tree.map(jnp.asarray, self.jtree)
        logits = np.asarray(jax.jit(jstep)(jp, jax.tree.map(jnp.asarray,
                                                            prefill)))
        dstep, jlm = jmake_decode(self.jcfg, dtype=jnp.float32)
        dstep = jax.jit(dstep)
        cache = jlm.init_cache(B, SLOTS, dtype=jnp.float32)
        picked = []
        for i in range(STEPS):
            nxt, cache = dstep(jp, cache, jnp.asarray(decode[:, i:i + 1]))
            picked.append(np.asarray(nxt))
        tstep, _ = jmake_train_step(self.jcfg, JTrainConfig(**TCFG))
        jtp = jax.tree.map(lambda x: jnp.broadcast_to(
            jnp.asarray(x)[None], (g,) + x.shape), self.jtrain_tree)
        new, _, metrics = jax.jit(tstep)(
            jtp, (), jax.tree.map(jnp.asarray, train), key)
        return dict(prefill=logits,
                    decode=(np.concatenate(picked, 1),
                            [np.asarray(x) for x in jax.tree.leaves(cache)]),
                    train=([np.asarray(x[0]) for x in jax.tree.leaves(new)],
                           {k: float(v) for k, v in metrics.items()}))

    def cases(self, tag, mesh, g, kinds, tcfg=None):
        prefill, decode, train, _, first = self.inputs[g]
        out = {}
        if "prefill" in kinds:
            for plan in kinds["prefill"]:
                out[(tag, "prefill", plan)] = dict(
                    kind="prefill", mesh=mesh, cfg=self.cfg,
                    params=self.params, plan=plan, batch=_torch(prefill))
        if "decode" in kinds:
            out[(tag, "decode")] = dict(
                kind="decode", mesh=mesh, cfg=self.cfg, params=self.params,
                tokens=torch.from_numpy(decode), slots=SLOTS)
        if "train" in kinds:
            out[(tag, "train")] = dict(
                kind="train", mesh=mesh, cfg=self.cfg,
                tcfg=tcfg or TrainConfig(**TCFG), g=g,
                params=self.train_params,
                batch=_torch(train), first=first)
        return out


def _spawn(tmp, world, job):
    job_path = str(tmp / f"job_{world}.pt")
    torch.save(job, job_path)
    return [(r, str(tmp / f"out_{world}_{r}.pt"), subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world),
         str(tmp / f"init_{world}"), job_path,
         str(tmp / f"out_{world}_{r}.pt")],
        env={**os.environ, "PYTHONPATH": SRC}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return once(tmp_path_factory, "model_axis_worlds",
                lambda: _worlds(tmp_path_factory.mktemp("model_axis")))


def _worlds(tmp):
    llama = Port("llama3.2-1b", 1, (1, 2))
    others = {a: Port(a, 3 + i, (1,)) for i, a in enumerate(ARCHS)}
    two = llama.cases("1x2", (1, 2), 1, {"prefill": ("decode", "prefill"),
                                         "decode": 1, "train": 1})
    two.update(llama.cases("1x2 momentum", (1, 2), 1, {"train": 1},
                           TrainConfig(**TCFG, momentum=0.9)))
    seq = TrainConfig(**TCFG, seq_shard_activations=True)
    two.update(llama.cases("1x2 seq", (1, 2), 1, {"train": 1}, seq))
    for arch, port in others.items():
        two.update(port.cases(arch, (1, 2), 1, {"prefill": ("decode",),
                                                "decode": 1, "train": 1}))
        two.update(port.cases(arch + " seq", (1, 2), 1, {"train": 1}, seq))
    four = llama.cases("2x2", (2, 2), 2, {"prefill": ("decode",),
                                          "decode": 1, "train": 1})
    four.update(llama.cases("1x4", (1, 4), 1, {"prefill": ("decode",),
                                               "train": 1}))
    four.update(llama.cases("2x2 seq", (2, 2), 2, {"train": 1}, seq))
    odd = Port(ODD, 9, (1,))
    four.update(odd.cases(ODD, (1, 4), 1, {"prefill": ("prefill",),
                                           "train": 1}))
    two.update(_row_cases())
    two.update(_count_cases(llama))
    procs = {2: _spawn(tmp, 2, two), 4: _spawn(tmp, 4, four)}

    # meanwhile: the one-rank steps and the reference's
    one = {("llama", g): llama.one_rank(g, data=g) for g in (1, 2)}
    one.update({(a, 1): p.one_rank(1) for a, p in others.items()})
    one[(ODD, 1)] = odd.one_rank(1)
    one["momentum"] = llama.one_rank_train(1, TrainConfig(**TCFG,
                                                          momentum=0.9))
    ref = {g: llama.reference(g) for g in (1, 2)}

    outs = {}
    for world, ps in procs.items():
        for r, out, proc in ps:
            try:
                log, _ = proc.communicate(timeout=400)
            finally:
                proc.kill()
            assert proc.returncode == 0, f"rank {r} of {world}:\n{log[-3000:]}"
            outs[(world, r)] = torch.load(out, weights_only=False)
    return dict(outs=outs, one=one, ref=ref, llama=llama)


def _count_cases(port):
    """llama's prefill (on prefill's plan) and a decode step over SLOTS
    slots on 1 x 2 in the dry run's dtypes (bf16 weights, cache and
    compute): the collectives its ranks call, for its count."""
    prefill, decode, _, _, _ = port.inputs[1]
    bf16 = tree_map(lambda x: x.to(torch.bfloat16), port.params)
    return {("1x2 count", "prefill", "prefill"): dict(
        kind="prefill", mesh=(1, 2), cfg=port.cfg, params=bf16,
        plan="prefill", batch=_torch(prefill), dtype=torch.bfloat16),
        ("1x2 count", "decode"): dict(
            kind="decode", mesh=(1, 2), cfg=port.cfg, params=bf16,
            tokens=torch.from_numpy(decode[:, :1]), slots=SLOTS,
            dtype=torch.bfloat16)}


def _row_cases():
    """bf16 operands of a row-parallel product over 1 x 2, with each
    rank's upstream gradient (the same on both where the output is
    reduced, each its own where every rank reads the sum)."""
    rng = np.random.default_rng(11)

    def bf16(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(
            torch.bfloat16)
    a, w = bf16(64, 256), bf16(256, 96, scale=0.05)
    g = bf16(64, 96)
    return {("row", shared): dict(kind="row", mesh=(1, 2), a=a, w=w,
                                  shared=shared,
                                  g=[g, bf16(64, 96)] if shared else [g, g])
            for shared in (False, True)}


def _ranks(worlds, world, key):
    """Every rank's (result, heads seen) of one case, the results the
    same bits on every rank."""
    runs = [worlds["outs"][(world, r)][key] for r in range(world)]
    first = tree_leaves(runs[0][0])
    for got, _ in runs[1:]:
        again = tree_leaves(got)
        assert len(again) == len(first)
        assert all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                   else a == b for a, b in zip(again, first))
    return runs


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _one_rank_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _ref_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


LLAMA = {"1x2": (2, 1), "2x2": (4, 2), "1x4": (4, 1)}  # mesh -> world, G


@pytest.mark.parametrize("mesh,plan", [("1x2", "decode"),
                                       ("1x2", "prefill"),
                                       ("2x2", "decode"),
                                       ("1x4", "decode")])
def test_prefill_on_the_model_axis(worlds, mesh, plan):
    world, g = LLAMA[mesh]
    runs = _ranks(worlds, world, (mesh, "prefill", plan))
    got = runs[0][0]
    _one_rank_close(got, worlds["one"][("llama", g)]["prefill"])
    _ref_close(got, worlds["ref"][g]["prefill"])
    # each rank ran its own query heads: 4 over the model axis
    assert all(heads == [4 // (world // g)] for _, heads in runs)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_decode_on_the_model_axis(worlds, mesh):
    world, g = LLAMA[mesh]
    runs = _ranks(worlds, world, (mesh, "decode"))
    picked, cache = runs[0][0]
    want_picked, want_cache = worlds["one"][("llama", g)]["decode"]
    assert torch.equal(picked, want_picked)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)):
        _one_rank_close(a, b)
    ref_picked, ref_cache = worlds["ref"][g]["decode"]
    np.testing.assert_array_equal(picked.numpy(), ref_picked)
    got = _sorted_leaves(cache)          # jax.tree.leaves' order
    assert len(got) == len(ref_cache)
    for a, b in zip(got, ref_cache):
        _ref_close(a, b)
    assert all(heads == [2] for _, heads in runs)   # 4 heads over 2


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4"])
def test_train_step_on_the_model_axis(worlds, mesh):
    _check_train(worlds, mesh, mesh)


def _check_train(worlds, mesh, tag):
    """The train step of case ``tag`` on ``mesh`` against one rank's and
    the reference's; each rank ran its query heads."""
    world, g = LLAMA[mesh]
    runs = _ranks(worlds, world, (tag, "train"))
    (leaves, metrics), heads = runs[0]
    assert all(m == metrics for (_, m), _ in runs)
    one_leaves, one_metrics = worlds["one"][("llama", g)]["train"]
    assert metrics["selected"] == one_metrics["selected"] == g * MB
    for a, b in zip(leaves, one_leaves):
        _one_rank_close(a, b)
    for k in metrics:
        assert abs(metrics[k] - one_metrics[k]) <= 1e-5 * (
            1 + abs(one_metrics[k]))
    ref_leaves, ref_metrics = worlds["ref"][g]["train"]
    assert len(ref_leaves) == len(leaves)
    for a, b in zip(leaves, ref_leaves):
        _ref_close(a, b)
    for k in metrics:
        np.testing.assert_allclose(metrics[k], ref_metrics[k], rtol=TOL,
                                   atol=TOL)
    m = world // g
    assert heads == [4 // m]


@pytest.mark.parametrize("kind", ["prefill", "decode", "train",
                                  "train seq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_families_on_the_model_axis(worlds, arch, kind):
    """Each dense family's steps on 1 x 2 against one rank's; "train
    seq": the train step with the hidden states split on the sequence
    (whisper's encoder's too, internvl2's prefix among the positions)."""
    if kind == "prefill":
        key = (arch, "prefill", "decode")
    elif kind == "train seq":
        key = (arch + " seq", "train")
    else:
        key = (arch, kind)
    runs = _ranks(worlds, 2, key)
    got, heads = runs[0]
    want = worlds["one"][(arch, 1)][kind.split()[0]]
    if kind == "prefill":
        _one_rank_close(got, want)
    elif kind == "decode":
        assert torch.equal(got[0], want[0])
        for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])):
            _one_rank_close(a, b)
    else:
        assert got[1]["selected"] == want[1]["selected"]
        for a, b in zip(got[0], want[0]):
            _one_rank_close(a, b)
        for k in got[1]:
            assert abs(got[1][k] - want[1][k]) <= 1e-5 * (
                1 + abs(want[1][k]))
    assert heads == [2]                 # 4 heads over 2 ranks


# --------------------------------------------------------------------------
# (e) the builds on a fake world, and what a kernel wrapper refuses
# --------------------------------------------------------------------------
@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def join(world, shape):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        return mesh_over_world(shape, PRODUCTION_AXES if len(shape) == 2
                               else MULTI_POD_AXES, "cpu")
    yield join
    dist.destroy_process_group()


def _built(step, cfg, mesh):
    """Build ``step`` ("prefill" or "decode") of ``cfg`` on ``mesh`` ->
    the step's ranks, and for decode its cache there too."""
    from repro_torch.launch.steps import serve_ranks
    if step == "prefill":
        make_prefill_step(cfg, mesh=mesh)
        return serve_ranks(cfg, mesh), None
    from repro_torch.launch.specs import cache_on_mesh
    _, lm = make_decode_step(cfg, mesh=mesh)
    return serve_ranks(cfg, mesh), cache_on_mesh(lm, mesh, 2, 8)


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "rwkv6-3b"])
def test_the_families_inference_over_pod_raises(fake_world, arch, step):
    """Inference over "pod" no longer raises: on (2, 1, 2) the steps
    build, with the model axis and every group of the axes above 1 made
    at once (none inside a call), and decode's cache at batch 2 lies on
    ``cache_plan``'s placements, its batch over "pod"."""
    from repro_torch.optim.optimizers import tree_leaves
    mesh = fake_world(4, (2, 1, 2))
    sr, cache = _built(step, get_config(arch).reduced(), mesh)
    assert sr.fed is None and sr.data is None and sr.model.size == 2
    assert set(sr.grid.groups) == {("pod",), ("model",), ("pod", "model")}
    if cache is not None:                 # each pod its row of the batch
        pod = [x for x in tree_leaves(cache) if x.placements[0].is_shard()]
        assert pod and all(
            2 * x.to_local().shape[x.placements[0].dim]
            == x.shape[x.placements[0].dim] for x in pod)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-236b",
                                  "jamba-1.5-large-398b", "rwkv6-3b"])
def test_params_on_mesh_is_the_distributed_init(fake_world, arch):
    """``specs.params_on_mesh`` draws each leaf as ``LM.init`` does and
    keeps this rank's part: the bits of ``distribute_tree(lm.init(gen))``
    on decode's plan, leaf by leaf, with their placements."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.launch.specs import params_on_mesh, step_plan
    mesh = fake_world(2, (1, 2))
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    plan = step_plan(cfg, mesh_axis_sizes(mesh), "decode", lm=lm)
    got = params_on_mesh(lm, torch.Generator().manual_seed(5), plan, mesh,
                         dtype=torch.bfloat16)
    want = sh.distribute_tree(lm.init(torch.Generator().manual_seed(5),
                                      dtype=torch.bfloat16), plan, mesh)
    assert sh.placements_of(got) == sh.placements_of(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape and torch.equal(a.to_local(),
                                                  b.to_local())
    assert any(not p.is_replicate() for x in tree_leaves(got)
               for p in x.placements)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_sequence_sharded_activations_match(worlds, mesh):
    """The positions over "model" between blocks: the train step within
    f32 rounding of one rank's and 2e-3 of the reference's, on the
    head-aware train plan; its blocks reduce-scatter their outputs, where
    the step without the option all-reduces them."""
    _check_train(worlds, mesh, f"{mesh} seq")
    world = LLAMA[mesh][0]
    for r in range(world):
        outs = worlds["outs"][(world, r)]
        assert outs[(f"{mesh} seq", "train", "calls")].get(
            "reduce_scatter_cat", 0) > 0
        assert "reduce_scatter_cat" not in outs[(mesh, "train", "calls")]


@pytest.mark.parametrize("wrapper,args", [
    ("kmeans_pairwise_dist", lambda t: (t((8, 4)), t((3, 4)))),
    ("kmeans_lloyd_step", lambda t: (t((8, 4)), t((3, 4)), t((8, 3)))),
    ("quantize_affine", lambda t: (t((8, 4)), torch.ones(8, dtype=bool))),
    ("quantize_affine_batched",
     lambda t: (t((2, 8, 4)), torch.ones(2, 8, dtype=bool))),
    ("flash_attention", lambda t: (t((1, 4, 2, 8)),) * 3),
    ("flash_attention_bwd",
     lambda t: (t((1, 4, 2, 8)),) * 5 + (t((1, 2, 4)),)),
    ("flash_decode", lambda t: (t((1, 1, 2, 8)), t((1, 4, 2, 8)),
                                t((1, 4, 2, 8)),
                                torch.ones(1, 4, dtype=bool)))])
def test_a_dtensor_reaches_no_kernel(fake_world, wrapper, args):
    from torch.distributed.tensor import DTensor, Replicate
    mesh = fake_world(2, (1, 2))

    def dt(shape):
        return DTensor.from_local(torch.zeros(shape), mesh,
                                  (Replicate(), Replicate()),
                                  run_check=False)
    with pytest.raises(TypeError, match=wrapper):
        getattr(ops, wrapper)(*args(dt))


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_query_heads_split_mid_head(worlds, kind):
    """10 heads of 32 over 4 ranks: 80 columns a rank, so rank 1 holds
    heads 2.5-5 and computes heads 2-4, which read kv heads 1 and 2 as
    1, 1, 2 (no GQA order of 3 over 2)."""
    from repro_torch.models.model_axis import head_share
    assert head_share(10, 5, 32, 80, 160).kv_index == [0, 0, 1]
    key = (ODD, "prefill", "prefill") if kind == "prefill" else (ODD, kind)
    runs = _ranks(worlds, 4, key)
    got, _ = runs[0]
    want = worlds["one"][(ODD, 1)][kind]
    if kind == "prefill":
        _one_rank_close(got, want)
    else:
        for a, b in zip(got[0], want[0]):
            _one_rank_close(a, b)
        for k in got[1]:
            assert abs(got[1][k] - want[1][k]) <= 1e-5 * (
                1 + abs(want[1][k]))
    assert sorted({h for _, heads in runs for h in heads}) == [3]


def test_train_step_with_momentum_on_the_model_axis(worlds):
    """A momentum's state rides the parameters' placements: the new
    weights and the momentum, gathered, within f32 rounding of one
    rank's."""
    runs = _ranks(worlds, 2, ("1x2 momentum", "train"))
    (leaves, metrics), _ = runs[0]
    want_leaves, want_metrics = worlds["one"]["momentum"]
    assert len(leaves) == len(want_leaves)
    for a, b in zip(leaves, want_leaves):
        _one_rank_close(a, b)
    for k in metrics:
        assert abs(metrics[k] - want_metrics[k]) <= 1e-5 * (
            1 + abs(want_metrics[k]))


@pytest.mark.parametrize("shared", [False, True])
def test_row_product_rounds_once(worlds, shared):
    """A row-parallel product in bf16 keeps each rank's partial in f32
    and rounds the sum once, as one rank's GEMM rounds its f32
    accumulation once; summing bf16 partials lies farther from the
    exact product. Its gradients are one rank's: ``g @ w.T`` and
    ``a.T @ g``, ``g`` summed over the ranks where every rank reads the
    sum (``shared``)."""
    case = _row_cases()[("row", shared)]
    (y, ga, gw), _ = _ranks(worlds, 2, ("row", shared))[0]
    a, w = case["a"], case["w"]
    h = a.shape[1] // 2
    parts = [a[:, :h].contiguous().float() @ w[:h].float(),
             a[:, h:].contiguous().float() @ w[h:].float()]
    assert torch.equal(y, (parts[0] + parts[1]).to(torch.bfloat16))
    exact = a.double() @ w.double()
    twice = (parts[0].bfloat16() + parts[1].bfloat16()).double()
    assert (torch.linalg.norm(y.double() - exact)
            < torch.linalg.norm(twice - exact))
    g = (case["g"][0].double() + case["g"][1].double() if shared
         else case["g"][0].double())
    for got, want in ((ga, g @ w.double().t()), (gw, a.double().t() @ g)):
        assert got.dtype == torch.bfloat16
        assert (torch.linalg.norm(got.double() - want)
                / torch.linalg.norm(want)) < 1e-2


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_the_dry_run_counts_the_ranks_collectives(worlds, kind):
    """The dry run's count of each rank of 1 x 2 (llama, 4 layers:
    prefill of B x S on prefill's plan and a decode step over SLOTS
    slots in bf16, the train round of (b)) equals, by kind, in count and
    bytes, the collectives that rank of the world called in the step."""
    import torch_model_axis_families as F
    key, shape, override = {
        "prefill": (("1x2 count", "prefill", "prefill"), "prefill_32k",
                    {"seq_len": S, "global_batch": B}),
        "decode": (("1x2 count", "decode"), "decode_32k",
                   {"seq_len": SLOTS, "global_batch": B}),
        "train": (("1x2", "train"), "train_4k",
                  {"seq_len": T, "global_batch": MB})}[kind]
    for rank in range(2):
        F.check_collectives(worlds["outs"], 2, rank, key, "llama3.2-1b",
                            shape, {"data": 1, "model": 2},
                            shape_override=override,
                            cfg_override={"num_layers": 4},
                            tcfg=TrainConfig(**TCFG))
