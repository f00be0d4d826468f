"""Decode caches split on the sequence or the head dim, and the decode
kernel's softmax statistics.

(a) On the CPU, in f64: ``ops.flash_decode(..., stats=True)`` (its plain
    version, ``ref.flash_decode_stats_ref``) gives each (b, head)'s output
    over the slots it is given and lse = m + log(l); the merge
    (``layers.merge_parts``) of a ring's slots cut into 2, 3 and 4 parts
    equals the decode over the whole ring, a part with no valid slot
    weighing exactly 0, and a ring with none at all giving the uniform
    weights over all S slots, as one rank's decode. The ring's write and
    valid mask on a split ring (``ring_write``, ``ring_valid``).
(b) Gloo worlds of 2 and 4 processes (``tests/torch_model_axis_worker.py``)
    decode 10 teacher-forced steps over an 8-slot ring (which wraps; the
    rank holding the later slots has none valid for the first steps) on
    every placement ``cache_plan`` makes of a k/v or latent ring:
    * the sequence over "data" at batch 1 (long_500k's plan): gemma3-4b
      (its local rings of 8 slots and its global ring both split) and
      deepseek-v2-236b's latent ring, naive and absorbed, on 2 x 1;
    * ``cache_seq_shard``, the sequence over "model": llama3.2-1b (4
      heads over 2: every rank's query heads gathered to attend its
      slots) and deepseek on 1 x 2, and llama over ("data", "model") on
      2 x 2;
    * the head dim over "model" on 1 x 4, where 2 kv heads do not
      divide 4: llama3.2-1b (its 4 query heads one a rank, each gathering
      the head-dim columns), qwen3-moe-30b-a3b and jamba-1.5-large-398b.
    Levels: every rank the same bits; in f32 within 2e-3 of the
    reference's unsharded ``make_decode_step`` (the tokens equal to it
    and to the port's one rank), in f64 within rtol 1e-5 / atol 1e-6 of
    the port's one-rank decode in f64.
"""
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_model_axis as M
import torch_model_axis_families as F
from repro.launch.steps import make_decode_step as jmake_decode
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import layers as L
from repro_torch.optim.optimizers import tree_leaves, tree_map
from test_torch_round import one_torch_thread  # noqa: F401
from torch_once import once

SLOTS, STEPS = 8, 10
LLAMA, GEMMA, DEEPSEEK = "llama3.2-1b", "gemma3-4b", "deepseek-v2-236b"
MOE, JAMBA = "qwen3-moe-30b-a3b", "jamba-1.5-large-398b"
# tag -> (port, mesh, world, rows, seq_shard)
CASES = {
    "gemma data": (GEMMA, (2, 1), 2, 1, False),
    "deepseek data": (DEEPSEEK, (2, 1), 2, 1, False),
    "absorbed data": ("absorbed", (2, 1), 2, 1, False),
    "llama model": (LLAMA, (1, 2), 2, 1, True),
    "deepseek model": (DEEPSEEK, (1, 2), 2, 1, True),
    "llama data model": (LLAMA, (2, 2), 4, 1, True),
    "llama head dim": (LLAMA, (1, 4), 4, 2, False),
    "moe head dim": (MOE, (1, 4), 4, 2, False),
    "jamba head dim": (JAMBA, (1, 4), 4, 2, False),
}


# --------------------------------------------------------------------------
# (a) the statistics and the merge
# --------------------------------------------------------------------------
def _qkv(b, s, h, kv, d, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, 1, h, d, generator=g, dtype=dtype),
            torch.randn(b, s, kv, d, generator=g, dtype=dtype),
            torch.randn(b, s, kv, d, generator=g, dtype=dtype))


def _whole(q, k, v, valid):
    """The decode over every slot in f64: the softmax of the scaled
    scores (NEG where invalid) times v."""
    rep = q.shape[2] // k.shape[2]
    k, v = (torch.repeat_interleave(t, rep, 2) for t in (k, v))
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0], k) / math.sqrt(q.shape[-1])
    s = torch.where(valid[:, None], s, L.NEG)
    return torch.einsum("bhk,bkhd->bhd", torch.softmax(s, -1), v)[:, None]


def test_the_statistics_of_the_plain_version():
    q, k, v = _qkv(2, 24, 4, 2, 16, 1)
    valid = torch.rand(2, 24, generator=torch.Generator().manual_seed(2)) \
        < 0.5
    o, lse = ops.flash_decode(q.float(), k.float(), v.float(), valid,
                              stats=True)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == (2, 1, 4, 16) and lse.shape == (2, 4)
    o64, lse64 = ref.flash_decode_stats_ref(q, k, v, valid)
    torch.testing.assert_close(o64, _whole(q, k, v, valid), rtol=1e-12,
                               atol=1e-12)
    rep = torch.repeat_interleave(k, 2, 2)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0], rep) / 4.0
    s = torch.where(valid[:, None], s, L.NEG)
    torch.testing.assert_close(lse64, torch.logsumexp(s, -1), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(o, o64.float(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, lse64.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_the_merge_of_split_statistics_is_the_whole_decode(parts):
    """The ring cut into even parts; row 0's first part has no valid slot
    (its weight exactly 0), row 1 has none anywhere (uniform over all S
    slots: the mean of v), row 2 a few valid slots in one part."""
    s = 12 * parts
    q, k, v = _qkv(3, s, 6, 3, 8, parts)
    valid = torch.rand(3, s, generator=torch.Generator().manual_seed(5)) \
        < 0.6
    valid[0, :12] = False
    valid[1] = False
    valid[2] = False
    valid[2, 12 * (parts - 1) + 3:12 * (parts - 1) + 5] = True
    got = [ref.flash_decode_stats_ref(q, k[:, 12 * i:12 * (i + 1)],
                                      v[:, 12 * i:12 * (i + 1)],
                                      valid[:, 12 * i:12 * (i + 1)])
           for i in range(parts)]
    merged = L.merge_parts(torch.stack([o for o, _ in got]),
                           torch.stack([lse for _, lse in got]),
                           torch.float64)
    torch.testing.assert_close(merged, _whole(q, k, v, valid), rtol=1e-12,
                               atol=1e-12)
    mean_v = torch.repeat_interleave(v, 2, 2).mean(1, keepdim=True)
    torch.testing.assert_close(merged[1], mean_v[1], rtol=1e-12,
                               atol=1e-12)
    w = torch.stack([lse for _, lse in got])
    assert torch.all(torch.exp(w[0, 0] - w[:, 0].amax(0)) == 0)


def test_a_split_ring_writes_and_reads_its_own_slots():
    """Slot ``pos % size`` of a ring of 8 split in 2: only the rank that
    holds it writes (rows at other slots left as they were); the valid
    mask of each rank's slots is the whole ring's."""
    pos = torch.tensor([2, 5, 13])               # slots 2, 5 and 5
    new = torch.arange(3.0)[:, None].expand(3, 4) + 1
    whole = torch.zeros(3, 8, 4)
    L.ring_write(whole, new, pos, None)
    for index in range(2):
        seq = L.SeqSplit(None, index, 2, ("data",))
        ring = torch.zeros(3, 4, 4)
        L.ring_write(ring, new, pos, seq)
        assert torch.equal(ring, whole[:, 4 * index:4 * index + 4])
        assert torch.equal(
            L.ring_valid(4, pos, seq, "cpu"),
            L.ring_valid(8, pos, None, "cpu")[:, 4 * index:4 * index + 4])


def test_the_decode_step_returns_its_logits_when_asked():
    """``make_decode_step(return_logits=True)``: the same token and cache
    as without, and the new position's logits, whose argmax the token
    is."""
    cfg = get_config(LLAMA).reduced()
    plain, lm = make_decode_step(cfg, dtype=torch.float32)
    with_logits, _ = make_decode_step(cfg, dtype=torch.float32,
                                      return_logits=True)
    params = lm.init(torch.Generator().manual_seed(3))
    tokens = torch.tensor([[5], [7]])
    nxt, cache = plain(params, lm.init_cache(2, SLOTS, dtype=torch.float32),
                       tokens)
    nxt2, cache2, logits = with_logits(
        params, lm.init_cache(2, SLOTS, dtype=torch.float32), tokens)
    assert torch.equal(nxt, nxt2) and logits.shape == (2, cfg.padded_vocab)
    assert torch.equal(logits.argmax(-1).to(nxt.dtype), nxt[:, 0])
    for a, b in zip(tree_leaves(cache), tree_leaves(cache2)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# (b) decode on every placement of a ring
# --------------------------------------------------------------------------
def _tokens(port, rows):
    return port.inputs[1][1][:rows]


def one_rank_decode(port, rows, dtype):
    """The port's one-rank teacher-forced decode of the first ``rows``
    rows -> (tokens, cache)."""
    step, lm = make_decode_step(port.cfg, dtype=dtype)
    params = tree_map(lambda x: x.to(dtype), port.params)
    cache = lm.init_cache(rows, SLOTS, dtype=dtype)
    tokens, picked = _tokens(port, rows), []
    for i in range(STEPS):
        nxt, cache = step(params, cache, torch.from_numpy(tokens[:, i:i + 1]))
        picked.append(nxt)
    return torch.cat(picked, 1), cache


def reference_decode(port, rows):
    """The reference's unsharded decode of the same rows -> (tokens,
    cache leaves)."""
    jp = jax.tree.map(jnp.asarray, port.jtree)
    step, jlm = jmake_decode(port.jcfg, dtype=jnp.float32)
    step = jax.jit(step)
    cache = jlm.init_cache(rows, SLOTS, dtype=jnp.float32)
    tokens, picked = _tokens(port, rows), []
    for i in range(STEPS):
        nxt, cache = step(jp, cache, jnp.asarray(tokens[:, i:i + 1]))
        picked.append(np.asarray(nxt))
    return (np.concatenate(picked, 1),
            [np.asarray(x) for x in jax.tree.leaves(cache)])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return once(tmp_path_factory, "seq_cache_worlds",
                lambda: _worlds(tmp_path_factory))


def _worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_cache")
    ports = {arch: M.Port(arch, seed, (1,), train=False)
             for arch, seed in ((LLAMA, 71), (GEMMA, 73), (DEEPSEEK, 75),
                                (MOE, 77), (JAMBA, 79))}
    ports["absorbed"] = F.absorbed(copy.copy(ports[DEEPSEEK]))
    jobs = {2: {}, 4: {}}
    for tag, (arch, mesh, world, rows, seq_shard) in CASES.items():
        port = ports[arch]
        case = dict(kind="decode", mesh=mesh, cfg=port.cfg,
                    params=port.params, slots=SLOTS, seq_shard=seq_shard,
                    tokens=torch.from_numpy(_tokens(port, rows)))
        jobs[world][(tag, "decode")] = case
        jobs[world][(tag + " f64", "decode")] = dict(
            case, dtype=torch.float64,
            params=tree_map(lambda x: x.double(), port.params))
    procs = {w: F._spawn(tmp, w, job) for w, job in jobs.items()}

    # meanwhile: the port's one-rank decode and the reference's
    one, refs = {}, {}
    for arch, mesh, world, rows, _ in CASES.values():
        if (arch, rows) in one:
            continue
        one[(arch, rows)] = {dtype: one_rank_decode(ports[arch], rows, dtype)
                             for dtype in (torch.float32, torch.float64)}
        refs[(arch, rows)] = reference_decode(ports[arch], rows)
    return dict(outs=F.join(procs), one=one, ref=refs)


def _decode(worlds, tag):
    arch, _, world, rows, _ = CASES[tag]
    runs = F.ranks(worlds["outs"], world, (tag, "decode"))
    runs64 = F.ranks(worlds["outs"], world, (tag + " f64", "decode"))
    one = worlds["one"][(arch, rows)]
    F.check_serve("decode", runs[0][0], runs64[0][0], one[torch.float32],
                  one[torch.float64], worlds["ref"][(arch, rows)])
    return runs, [worlds["outs"][(world, r)][(tag, "decode", "gathered")]
                  for r in range(world)]


@pytest.mark.parametrize("tag", ["gemma data", "deepseek data",
                                 "absorbed data"])
def test_decode_at_batch_1_with_the_sequence_over_data(worlds, tag):
    runs, gathered = _decode(worlds, tag)
    if tag != "absorbed data":          # every head on every rank
        assert all(h == [4] for _, h in runs)
    assert gathered == [0, 0]


@pytest.mark.parametrize("tag", ["llama model", "deepseek model",
                                 "llama data model"])
def test_decode_with_cache_seq_shard(worlds, tag):
    """The reference's ``cache_seq_shard``: every query head attends each
    rank's slots, the ranks' statistics merged, each rank's heads kept for
    its rows of ``wo``."""
    runs, _ = _decode(worlds, tag)
    assert all(h == [4] for _, h in runs)


def test_a_cache_split_on_the_head_dim_runs(worlds):
    """At a model axis of 4 the reduced llama's 2 kv heads do not divide,
    so ``cache_plan`` splits the head dim: each rank writes its 8 of the
    32 columns and gathers the rest for its one query head."""
    runs, gathered = _decode(worlds, "llama head dim")
    assert all(h == [1] for _, h in runs)
    # 4 layers x 10 steps x k and v, 3/4 of (2 rows x 8 slots x 2 heads x
    # 32 columns) f32 bytes a gather
    assert gathered == [4 * STEPS * 2 * 3 * 2 * SLOTS * 2 * 32 * 4 // 4] * 4


@pytest.mark.parametrize("arch", [MOE, JAMBA])
def test_the_families_kv_cache_split_on_the_head_dim_runs(worlds, arch):
    """The reduced qwen3-moe's and jamba's 2 kv heads do not divide a
    model axis of 4, so ``cache_plan`` splits their k/v head dim."""
    runs, gathered = _decode(worlds, "moe head dim" if arch == MOE
                             else "jamba head dim")
    assert all(g > 0 for g in gathered)
