"""Two pods on ranks: gloo worlds on the CPU
(``tests/torch_model_axis_worker.py``, spawned once each while the
reference's steps compile) run the port's steps on meshes whose "pod" axis
is 2, their weights DTensors on the steps' plans.

The world of 4, on (2, 2, 1) and (2, 1, 2):

* prefill and teacher-forced decode (6 steps over a 4-slot ring, which
  wraps) of reduced llama3.2-1b (4 layers), qwen3-moe-30b-a3b,
  deepseek-v2-236b (FSDP: the planner's threshold at 0, so its weights'
  second dim lies over "data", gathered inside each pod),
  jamba-1.5-large-398b (its first 4 layers) and rwkv6-3b: on (2, 2, 1) at
  batch 4 (the rows over ("pod", "data"), a row a rank), 2 (the rows over
  "data", each pod a replica of the other) and 1 (each ring's slots over
  "data" inside each pod, the decode kernel's statistics merged), on
  (2, 1, 2) at batch 2 (the rows over "pod", the heads over "model");
* the train step with ``split_fl``: llama at G = 4 on (2, 2, 1) (a cohort
  a rank over the flattened ("pod", "data"), the FedAvg sum all-reduced
  over it), on (2, 1, 2) (two cohorts a pod, each tensor parallel over
  "model"), and deepseek with FSDP at G = 2 on (2, 2, 1)
  (the cohorts over "pod", each cohort's weights and rows over "data"
  inside its pod, the sum of each data shard all-reduced over "pod";
  rows of 256 tokens, so a data rank's 512 are a whole MoE group).

The world of 8, on (2, 2, 2): llama's decode at batch 1 with
``cache_seq_shard`` (the rings over ("data", "model") while "pod" is 2)
and its train step at G = 4 with "model" 2.

Levels: every rank the same bits; in f32 within 2e-3 of the reference's
unsharded ``make_prefill_step``, ``make_decode_step`` and
``make_train_step`` on the same numpy inputs and ``params_from_jax``
weights (the tokens equal); prefill and decode in f64 within rtol 1e-5 /
atol 1e-6 of the port's one-rank steps in f64 (in f32 a row split changes
the products' rounding: ``torch_model_axis_families.check_serve``), the
train step in f32 at that level of the port's one-rank step. And the
dry run's count of each rank of the (2, 2, 1) batch-1 decode (in the dry
run's bf16) equals, by kind, in count and bytes, the collectives that
rank called.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fsdp as TF
import test_torch_model_axis as M
import torch_model_axis_families as F
from repro.launch.steps import make_decode_step as jmake_decode
from repro.launch.steps import make_prefill_step as jmake_prefill
from repro_torch.configs import TrainConfig
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.optim.optimizers import tree_leaves, tree_map
from test_torch_round import one_torch_thread  # noqa: F401
from torch_once import once

LLAMA, MOE, MLA, JAMBA, RWKV = ("llama3.2-1b", "qwen3-moe-30b-a3b",
                                "deepseek-v2-236b", "jamba-1.5-large-398b",
                                "rwkv6-3b")
ARCHS = (LLAMA, MOE, MLA, JAMBA, RWKV)
FSDP = (MLA,)                        # inference with the weights over "data"
BATCH = 4                            # the inputs' rows; a case takes the first
# tag -> (mesh, batch)
SERVE = {"221 b4": ((2, 2, 1), 4), "221 b2": ((2, 2, 1), 2),
         "221 b1": ((2, 2, 1), 1), "212 b2": ((2, 1, 2), 2)}
# tag -> (world, mesh, arch, G)
TRAIN = {"221 llama": (4, (2, 2, 1), LLAMA, 4),
         "212 llama": (4, (2, 1, 2), LLAMA, 4),
         "221 deepseek": (4, (2, 2, 1), MLA, 2),
         "222 llama": (8, (2, 2, 2), LLAMA, 4)}
SEQ_SHARD = "222 b1 seq"             # llama, (2, 2, 2), batch 1
COUNT = "221 b1 count"               # llama's bf16 decode step, batch 1
SLOTS, STEPS = 4, 6                  # decode: 6 teacher-forced steps wrap


class PodPort(M.Port):
    """``Port`` with serving inputs of ``BATCH`` rows (a case takes the
    first b) and its arch cut as the tests of its family cut it."""

    def __init__(self, arch, seed, gs=(), train=False):
        cfgs = M._cfgs
        if arch == JAMBA:
            M._cfgs = lambda a: tuple(TF.cut_depth(c, 4) for c in cfgs(a))
        try:
            super().__init__(arch, seed, gs or (1,), train=train)
        finally:
            M._cfgs = cfgs
        rng = np.random.default_rng(seed + 5)
        self.serve = (
            {"tokens": rng.integers(0, self.cfg.vocab_size,
                                    (BATCH, M.S)).astype(np.int32)},
            rng.integers(0, self.cfg.vocab_size,
                         (BATCH, STEPS)).astype(np.int32))

    def rows(self, b):
        prefill, decode = self.serve
        return {k: v[:b] for k, v in prefill.items()}, decode[:b]

    def serve_cases(self, tag, mesh, b, **extra):
        """Prefill (on decode's plan) and decode at batch ``b``, in f32 and
        f64."""
        prefill, decode = self.rows(b)
        out = {}
        for dt, suffix in ((torch.float32, ""), (torch.float64, " f64")):
            params = tree_map(lambda x: x.to(dt), self.params)
            out[(tag + suffix, "prefill")] = dict(
                kind="prefill", mesh=mesh, cfg=self.cfg, params=params,
                plan="decode", batch=M._torch(prefill), dtype=dt, **extra)
            out[(tag + suffix, "decode")] = dict(
                kind="decode", mesh=mesh, cfg=self.cfg, params=params,
                tokens=torch.from_numpy(decode), slots=SLOTS, dtype=dt,
                **extra)
        return out

    def one_rank(self, b):
        """The port's one-rank prefill logits and decode (tokens, cache)
        at batch ``b`` in f64."""
        prefill, decode = self.rows(b)
        dtype = torch.float64
        params = tree_map(lambda x: x.to(dtype), self.params)
        logits = make_prefill_step(self.cfg, dtype=dtype)[0](
            params, M._torch(prefill))
        step, lm = make_decode_step(self.cfg, dtype=dtype)
        cache = lm.init_cache(b, SLOTS, dtype=dtype)
        picked = []
        for i in range(STEPS):
            nxt, cache = step(params, cache,
                              torch.from_numpy(decode[:, i:i + 1]))
            picked.append(nxt)
        return {"prefill": logits, "decode": (torch.cat(picked, 1), cache)}

    def reference(self, b):
        """The reference's unsharded prefill logits and decode (tokens,
        cache leaves) at batch ``b``, in f32."""
        prefill, decode = self.rows(b)
        jp = jax.tree.map(jnp.asarray, self.jtree)
        pstep, _ = jmake_prefill(self.jcfg, dtype=jnp.float32)
        logits = np.asarray(jax.jit(pstep)(jp, jax.tree.map(jnp.asarray,
                                                            prefill)))
        dstep, jlm = jmake_decode(self.jcfg, dtype=jnp.float32)
        dstep = jax.jit(dstep)
        cache = jlm.init_cache(b, SLOTS, dtype=jnp.float32)
        picked = []
        for i in range(STEPS):
            nxt, cache = dstep(jp, cache, jnp.asarray(decode[:, i:i + 1]))
            picked.append(np.asarray(nxt))
        return {"prefill": logits,
                "decode": (np.concatenate(picked, 1),
                           [np.asarray(x) for x in jax.tree.leaves(cache)])}


def _deepseek_train(seed):
    """deepseek's 2-layer cut with G = 2 cohorts of 4 rows of
    ``TRAIN_T`` tokens, and its first centres as the reference's key
    draws them."""
    port = TF.CutPort(MLA, seed)
    _, _, _, key, first = M._inputs(port.cfg, 2, seed + 20)
    rng = np.random.default_rng(seed + 8)
    train = {"tokens": rng.integers(0, port.cfg.vocab_size, (
        2, M.L_STEPS, 1, M.MB, TF.TRAIN_T)).astype(np.int32)}
    port.inputs[2] = (None, None, train, key, first)
    return port


def _fsdp(arch, cases):
    if arch not in FSDP:
        return cases
    return {k: dict(c, fsdp_threshold=0) for k, c in cases.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return once(tmp_path_factory, "pods_worlds",
                lambda: _worlds(tmp_path_factory.mktemp("pods")))


def _worlds(tmp):
    llama = PodPort(LLAMA, 200, gs=(4,), train=True)
    ports = {a: llama if a == LLAMA else PodPort(a, 200 + i)
             for i, a in enumerate(ARCHS)}
    ds = _deepseek_train(210)
    four, eight = {}, {}
    for arch, port in ports.items():
        for tag, (mesh, b) in SERVE.items():
            four.update(_fsdp(arch, port.serve_cases(f"{arch} {tag}", mesh,
                                                     b)))
    eight.update(ports[LLAMA].serve_cases(f"{LLAMA} {SEQ_SHARD}", (2, 2, 2),
                                          1, seq_shard=True))
    # the dry run's dtypes: bf16 weights, cache and compute
    _, decode = ports[LLAMA].rows(1)
    four[(COUNT, "decode")] = dict(
        kind="decode", mesh=(2, 2, 1), cfg=ports[LLAMA].cfg,
        params=tree_map(lambda x: x.to(torch.bfloat16), ports[LLAMA].params),
        tokens=torch.from_numpy(decode[:, :1]), slots=SLOTS,
        dtype=torch.bfloat16)
    for tag, (world, mesh, arch, g) in TRAIN.items():
        port = llama if arch == LLAMA else ds
        cases = port.cases(tag, mesh, g, {"train": 1})
        (four if world == 4 else eight).update(_fsdp(arch, cases))
    procs = {4: F._spawn(tmp, 4, four), 8: F._spawn(tmp, 8, eight)}

    # meanwhile: the port's one rank and the reference's unsharded steps
    one, ref = {}, {}
    for arch, port in ports.items():
        for b in (4, 2, 1):
            one[(arch, b)] = port.one_rank(b)
            ref[(arch, b)] = port.reference(b)
    tcfg = TrainConfig(**M.TCFG)
    one[(LLAMA, "train", 4)] = llama.one_rank_train(4, tcfg)
    ref[(LLAMA, "train", 4)] = F.reference_train(llama, 4)
    one[(MLA, "train", 2)] = ds.one_rank_train(2, tcfg)
    ref[(MLA, "train", 2)] = F.reference_train(ds, 2)
    return dict(outs=F.join(procs), one=one, ref=ref)


def _check_serve(worlds, world, tag, arch, b, kind):
    """``F.check_serve``'s levels; the f32 tokens held to the reference's
    and the f64 ranks' to one rank's."""
    key = f"{arch} {tag}"
    got = F.ranks(worlds["outs"], world, (key, kind))[0][0]
    got64 = F.ranks(worlds["outs"], world, (key + " f64", kind))[0][0]
    one64 = worlds["one"][(arch, b)][kind]
    ref = worlds["ref"][(arch, b)][kind]
    if kind == "prefill":
        M._ref_close(got, ref)
        M._one_rank_close(got64, one64)
        return
    (picked, cache), (picked64, cache64) = got, got64
    np.testing.assert_array_equal(picked.numpy(), ref[0])
    assert torch.equal(picked64, one64[0])
    for a, w in zip(tree_leaves(cache64), tree_leaves(one64[1])):
        M._one_rank_close(a, w)
    leaves = M._sorted_leaves(cache)         # jax.tree.leaves' order
    assert len(leaves) == len(ref[1])
    for a, w in zip(leaves, ref[1]):
        M._ref_close(a, w)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("tag", list(SERVE))
@pytest.mark.parametrize("arch", ARCHS)
def test_inference_over_two_pods(worlds, arch, tag, kind):
    """Each family's prefill logits and decode tokens and cache with the
    rows over ("pod", "data"), over "data" with the pods replicas, at
    batch 1 with the rings over "data" in each pod, and over "pod" with
    the heads over "model": every rank the same bits, within 2e-3 of the
    reference in f32 and 1e-5 of one rank in f64."""
    _check_serve(worlds, 4, tag, arch, SERVE[tag][1], kind)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_ring_over_some_axes_of_three(worlds, kind):
    """(2, 2, 2) at batch 1 with ``cache_seq_shard``: each ring over
    ("data", "model"), a group of 4 inside each pod, while "pod" is 2
    (the case that raised before)."""
    _check_serve(worlds, 8, SEQ_SHARD, LLAMA, 1, kind)


@pytest.mark.parametrize("tag", list(TRAIN))
def test_train_step_over_two_pods(worlds, tag):
    """A round over two pods: every rank leaves it with the same bits,
    within f32 rounding of the port's one-rank round and 2e-3 of the
    reference's."""
    world, _, arch, g = TRAIN[tag]
    runs = F.ranks(worlds["outs"], world, (tag, "train"))
    (leaves, metrics), _ = runs[0]
    assert all(m == metrics for (_, m), _ in runs)
    assert metrics["selected"] == g * M.MB
    F.check_train((leaves, metrics), worlds["one"][(arch, "train", g)],
                  worlds["ref"][(arch, "train", g)])


@pytest.mark.parametrize("rank", range(4))
def test_the_dry_run_counts_a_ranks_collectives(worlds, rank):
    """The dry run's count of the rank at each coordinate of (2, 2, 1)
    (llama's decode step at batch 1 over 4 slots, bf16: the ring's slots
    over "data") equals, by kind, in count and bytes, the collectives
    that rank of the world called in its first decode step."""
    F.check_collectives(worlds["outs"], 4, rank, (COUNT, "decode"), LLAMA,
                        "decode_32k", {"pod": 2, "data": 2, "model": 1},
                        shape_override={"seq_len": SLOTS,
                                        "global_batch": 1},
                        cfg_override={"num_layers": 4})
