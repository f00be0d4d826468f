"""The port's dry run (``repro_torch.launch.dryrun``) and its counter
(``launch/flop_analysis.py``) against ``repro``'s.

``repro``'s own dry run does not run on its smoke mesh (its embedding
gather raises ``ShardingTypeError`` under the 2 x 2 mesh: the four
``test_dryrun_*`` smokes of ``tests/test_distributed.py``), so the port is
held to the pieces of ``repro`` that run: ``resolve_mode``,
``count_params``, ``roofline_terms``' model FLOPs, the record keys its
``run_one`` writes (read from its source), and
``profiled_jit(step).cost(...)`` of
the reduced steps on one CPU device, split into the attention's share and
the rest (levels stated at each test)."""
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro.models.registry import count_params as jcount_params
from repro.obs.profile import profiled_jit
from repro_torch.configs import ARCHS, INPUT_SHAPES, TrainConfig, get_config
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, flop_analysis, steps
from repro_torch.models.registry import count_params
from repro_torch.models.transformer import tree_map

PAIRS = [(a, s) for a in ARCHS for s in INPUT_SHAPES]


@pytest.fixture(scope="module")
def jdryrun():
    """``repro.launch.dryrun``, imported without its import-time
    ``XLA_FLAGS`` (512 host devices) reaching jax or later subprocesses:
    jax's one CPU device is fixed first and the environment restored."""
    jax.devices()
    saved = dict(os.environ)
    try:
        from repro.launch import dryrun as jd
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return jd


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_modes_params_and_model_flops_equal_the_references(jdryrun, arch,
                                                           shape):
    """Level: exact — ``resolve_mode`` (runnable, force_swa, reason), the
    three parameter counts, and ``roofline_terms``' model FLOPs, total and
    ratio on the same record, for every (arch x shape) at full size."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dryrun.resolve_mode(cfg, shape) == jdryrun.resolve_mode(jcfg,
                                                                   shape)
    kinds = [{}, {"active_only": True},
             {"active_only": True, "include_embed": False}]
    counts = [count_params(cfg, **kw) for kw in kinds]
    assert counts == [jcount_params(jcfg, **kw) for kw in kinds]
    sh = INPUT_SHAPES[shape]
    rec = {"chips": 256, "global_batch": sh.global_batch,
           "seq_len": sh.seq_len, "kind": sh.kind,
           "nonembed_active_params": counts[2],
           "cost": {"flops_expanded": 3.5e15, "bytes_expanded": 1e12},
           "collectives": {"total_bytes": 1e9}}
    got = dryrun.roofline_terms(rec, TrainConfig())
    want = jdryrun.roofline_terms(rec, JTrainConfig())
    for key in ("model_flops", "hlo_flops_total", "useful_ratio"):
        assert got[key] == want[key], key


# ---------------------------------------------------------------- counts

B, S = 2, 128
TRAIN = dict(local_steps=2, microbatch=4, meta_clusters=2, meta_steps=2,
             pca_components=3)


def _stand_in(q, k, v, *args, **kwargs):
    """Attention with no product: q scaled by a sum over k and v (their
    gradients still flow, so no projection's backward is dropped)."""
    return q * (jnp.sum(k) + jnp.sum(v)).astype(q.dtype)


def _ref_costs(jcfg, with_attention: bool):
    """``repro``'s ``profiled_jit(step).cost(...)`` of the reduced
    prefill, decode and train steps (one CPU device); without attention's
    products where ``with_attention`` is False."""
    orig = (JL.sdpa_full, JL.sdpa_decode, JL.sdpa_chunked)
    if not with_attention:
        JL.sdpa_full = JL.sdpa_decode = JL.sdpa_chunked = _stand_in
    try:
        out = {}
        step, lm = jsteps.make_prefill_step(jcfg)
        params = lm.init(jax.random.PRNGKey(0))
        out["prefill"] = profiled_jit(step, name="prefill").cost(
            params, {"tokens": jnp.zeros((B, S), jnp.int32)})
        step, lm = jsteps.make_decode_step(jcfg)
        out["decode"] = profiled_jit(step, name="decode").cost(
            params, lm.init_cache(B, S, dtype=jnp.bfloat16),
            jnp.zeros((B, 1), jnp.int32))
        step, lm = jsteps.make_train_step(jcfg, JTrainConfig(**TRAIN))
        stacked = jax.tree.map(lambda x: x[None],
                               lm.init(jax.random.PRNGKey(0)))
        out["train"] = profiled_jit(step, name="train").cost(
            stacked, (), {"tokens": jnp.zeros((1, 2, 1, 4, S), jnp.int32)},
            jax.random.PRNGKey(1))
        return out
    finally:
        JL.sdpa_full, JL.sdpa_decode, JL.sdpa_chunked = orig


def _port_costs(cfg):
    """The port's counts of the same steps on meta tensors."""
    out = {}
    meta = dict(device="meta")
    step, lm = steps.make_prefill_step(cfg)
    params = lm.init(None, **meta)
    out["prefill"], _ = flop_analysis.count(
        step, params, {"tokens": torch.empty(B, S, dtype=torch.int32,
                                             **meta)})
    step, lm = steps.make_decode_step(cfg)
    out["decode"], _ = flop_analysis.count(
        step, params, lm.init_cache(B, S, dtype=torch.bfloat16, **meta),
        torch.empty(B, 1, dtype=torch.int32, **meta))
    step, lm = steps.make_train_step(cfg, TrainConfig(**TRAIN))
    stacked = tree_map(lambda x: x[None], lm.init(None, **meta))
    out["train"], _ = flop_analysis.count(
        step, stacked, (), {"tokens": torch.empty(1, 2, 1, 4, S,
                                                  dtype=torch.int32,
                                                  **meta)},
        torch.empty(1, dtype=torch.int64, **meta))
    return out


@pytest.fixture(scope="module")
def counts():
    """{arch: (repro's costs, repro's without attention, the port's)}
    for the reduced dense llama3.2-1b and MoE qwen3-moe-30b-a3b."""
    out = {}
    for arch in ("llama3.2-1b", "qwen3-moe-30b-a3b"):
        jcfg = jget_config(arch).reduced()
        out[arch] = (_ref_costs(jcfg, True), _ref_costs(jcfg, False),
                     _port_costs(get_config(arch).reduced()))
    return out


def _attention(sc):
    return sum(v for k, v in sc.kernel_flops.items()
               if k.startswith("flash"))


def _dispatch(cfg, tokens):
    """The FLOPs of ``repro``'s GShard dispatch a MoE layer
    (``repro/models/layers.py:538-545``): the dispatch and combine
    one-hot einsums (2 G gs k E cap each) and the einsums that move the
    tokens into and out of the capacity slots (2 G gs E cap d each). The
    port gathers and scatters the rows instead, with no product."""
    g = max(tokens // 512, 1)
    gs = tokens // g
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = max(int(gs * k / e * 1.25), 1)
    return 2 * (2 * g * gs * k * e * cap) + 2 * (2 * g * gs * e * cap
                                                 * cfg.d_model)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-30b-a3b"])
def test_inference_counts_against_the_references(counts, arch):
    """Prefill (B 2, S 128) and one decode step over a 128-slot cache.

    *The rest* (every product outside attention: projections, FFN or
    experts at capacity, router, the head at the last position): exact,
    the same 2 M N K over the same shapes; for the MoE after taking out
    ``repro``'s dispatch einsums (``_dispatch``), which the port does not
    run. *Attention*: the prefill kernel counts the causal half of the S x
    S pairs, ``repro``'s ``sdpa_full`` forms every pair: exactly half;
    decode reads every slot in both: equal. *Bytes*: both count each op's
    operands and outputs, ``repro`` at fusion boundaries and the port op
    by op; ``repro``'s ``sdpa_full`` writes the S x S scores and its ring
    write rewrites the whole cache (``jnp.where``), which the kernels and
    the port's in-place write do not: the port's bytes lie within 0.2x
    and 1x of ``repro``'s."""
    ref, ref_rest, port = counts[arch]
    cfg = get_config(arch).reduced()
    for kind, tokens in (("prefill", B * S), ("decode", B)):
        r, rr, p = ref[kind], ref_rest[kind], port[kind]
        extra = (cfg.num_layers * _dispatch(cfg, tokens) if cfg.is_moe
                 else 0)
        assert p.flops - _attention(p) == rr.flops - extra, kind
        ref_attention = r.flops - rr.flops
        assert _attention(p) == (ref_attention / 2 if kind == "prefill"
                                 else ref_attention), kind
        assert 0.2 * r.hbm_bytes <= p.bytes <= r.hbm_bytes, kind


def test_train_counts_against_the_references(counts):
    """One round of the reduced dense step (one cohort, 2 local steps of
    4 sequences of 128, the split-FL path: selection, 2 meta steps on 2
    selected rows).

    *The rest*: equal up to two terms. The port's meta step takes the
    head and its log-softmax a chunk at a time under
    ``torch.utils.checkpoint``, so its backward recomputes the head's
    product: + 2 x meta_steps x 2 rows x S x d x V. The K-means of the
    selection differs in its element-wise terms (the port's kernels count
    them, ``repro``'s distances are dots; one Lloyd sweep each): within
    1e-6 of the total. *Attention*: the kernels count the kept pairs
    (causal half, the backward's five products, remat's recompute of the
    forward); ``repro``'s ``sdpa_full`` under autodiff forms every pair:
    the port's share is below ``repro``'s. *Bytes* within 0.2x and 1x, as
    for inference."""
    ref, ref_rest, port = counts["llama3.2-1b"]
    cfg = get_config("llama3.2-1b").reduced()
    r, rr, p = ref["train"], ref_rest["train"], port["train"]
    rows = TRAIN["meta_clusters"]
    head = TRAIN["meta_steps"] * 2 * rows * S * cfg.d_model \
        * cfg.padded_vocab
    assert p.flops - _attention(p) - head == pytest.approx(rr.flops,
                                                           rel=1e-6)
    assert 0 < _attention(p) < r.flops - rr.flops
    assert p.unknown_trips == r.unknown_trip_loops == 1
    assert 0.2 * r.hbm_bytes <= p.bytes <= r.hbm_bytes


def test_moe_train_counts_below_the_references(counts):
    """The MoE's train round: ``repro``'s dispatch einsums run in the
    forward, remat's recompute and their gradients, which the port's
    gather and scatter do not; the experts run at capacity in both. The
    port's rest lies below ``repro``'s and above its dense part without
    the experts' capacity (a lower bound stated, not a term-by-term
    equality)."""
    ref, ref_rest, port = counts["qwen3-moe-30b-a3b"]
    p, rr = port["train"], ref_rest["train"]
    assert 0.3 * rr.flops < p.flops - _attention(p) < rr.flops


# ---------------------------------------------------------------- the CLI

REPRO_KEYS = {"arch", "shape", "multi_pod", "tag", "status", "reason",
              "chips", "force_swa", "seq_len", "global_batch", "kind",
              "t_lower_s", "t_compile_s", "params", "active_params",
              "nonembed_active_params", "memory", "cost", "collectives",
              "hlo_bytes", "roofline"}


@pytest.fixture(scope="module")
def smoke_all(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    rc = dryrun.main(["--smoke", "--all", "--out", str(out)])
    return rc, out


def _reference_record_keys():
    """The keys ``repro``'s ``run_one`` puts in an ``ok`` record, read
    from its source (its ``rec`` literal, ``rec.update(...)`` keywords and
    ``rec[...] =`` items outside the ``except`` branch): its dry run
    raises before it writes one (``ShardingTypeError`` on the smoke mesh
    and on a 1 x 1 mesh alike)."""
    import ast
    import inspect
    from repro.launch import dryrun as jd
    fn = ast.parse(inspect.getsource(jd.run_one)).body[0]
    errors = {id(n) for h in ast.walk(fn) if isinstance(h, ast.ExceptHandler)
              for n in ast.walk(h)}
    keys = set()
    for node in ast.walk(fn):
        if id(node) in errors:
            continue
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "rec"):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"
                and getattr(node.func.value, "id", None) == "rec"):
            keys |= {kw.arg for kw in node.keywords}
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].value, "id", None) == "rec"):
            keys.add(node.targets[0].slice.value)
    return keys


def test_records_carry_the_reference_keys(jdryrun):
    """The port's record of a pair carries every key of ``repro``'s
    (top level read from its source), and in ``cost``, ``collectives``,
    ``memory`` and ``roofline`` the keys ``repro`` writes there
    (``repro/launch/dryrun.py:121-145,162-188``; ``optimal_seconds`` is
    XLA's own estimate, which has no counterpart)."""
    assert _reference_record_keys() == REPRO_KEYS
    port = dryrun.run_one("llama3.2-1b", "decode_32k", smoke=True,
                          verbose=False)
    assert REPRO_KEYS <= set(port)
    inner = {"cost": {"flops", "bytes accessed", "transcendentals",
                      "flops_expanded", "bytes_expanded"},
             "collectives": {"total_bytes", "bytes_by_kind", "count_by_kind",
                             "unknown_trip_counts"},
             "memory": {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes",
                        "generated_code_size_in_bytes"},
             "roofline": {"compute_s", "memory_s", "collective_s", "bound",
                          "model_flops", "hlo_flops_total", "useful_ratio"}}
    for key, want in inner.items():
        assert want <= set(port[key]), key


def test_smoke_all_exits_0_with_every_pair_ok_or_skipped(smoke_all,
                                                         jdryrun):
    """``--smoke --all`` in process: exit 0, every pair ``ok`` or ``skip``
    with ``repro``'s reasons; an ``ok`` pair writes a JSON with
    ``repro``'s keys and a skipped one writes none, as ``repro``'s; every
    record is one rank's exact count, the smoke mesh's model axis of 2
    included."""
    import json
    rc, out = smoke_all
    assert rc == 0
    recs = {(r["arch"], r["shape"]): r for r in
            (json.loads(p.read_text()) for p in out.glob("*.json"))}
    runnable = set()
    for arch, shape in PAIRS:
        ok, _, reason = jdryrun.resolve_mode(jget_config(arch).reduced(),
                                             shape)
        if ok:
            runnable.add((arch, shape))
        else:
            rec = dryrun.run_one(arch, shape, smoke=True, verbose=False)
            assert (rec["status"], rec["reason"]) == ("skip", reason)
    assert set(recs) == runnable and len(runnable) == 39
    for (arch, shape), rec in recs.items():
        assert rec["status"] == "ok", rec.get("error")
        assert REPRO_KEYS <= set(rec)
        assert rec["reason"] == jdryrun.resolve_mode(
            jget_config(arch).reduced(), shape)[2]
        assert rec["per_device_rule"] == "exact"
        assert rec["cost"]["flops_expanded"] > 0
        assert rec["memory"]["temp_size_in_bytes"] is None


def test_a_mesh_the_port_runs_counts_one_ranks_share():
    """Model axis 1: the count is one rank's, exactly. With the cohorts
    over 2 ranks the rank runs one of the two cohorts and joins the
    FedAvg all-reduce (every leaf) and the gathers of losses and selected
    rows, charged by kind; on one device no collective."""
    one = dryrun.run_one("llama3.2-1b", "train_4k", smoke=True,
                         axes={"data": 1, "model": 1}, verbose=False)
    two = dryrun.run_one("llama3.2-1b", "train_4k", smoke=True,
                         axes={"data": 2, "model": 1}, verbose=False)
    assert one["per_device_rule"] == two["per_device_rule"] == "exact"
    assert one["collectives"]["total_bytes"] == 0
    leaves = len(jax.tree.leaves(jsteps.make_train_step(
        jget_config("llama3.2-1b").reduced(), JTrainConfig())[1].init(
            jax.random.PRNGKey(0))))
    assert two["collectives"]["count_by_kind"]["all-reduce"] == leaves
    assert two["collectives"]["count_by_kind"]["all-gather"] > 0
    # the replicated meta step and the rank's cohort: the rank counts
    # less than the whole two-cohort step
    whole = dryrun.run_one("llama3.2-1b", "train_4k", smoke=True,
                           axes={"data": 2, "model": 2}, verbose=False)
    assert two["cost"]["flops"] < whole["cost"]["flops"] * whole["chips"]


# one arch of each family
FAMILIES = ("llama3.2-1b", "qwen3-moe-30b-a3b", "deepseek-v2-236b",
            "jamba-1.5-large-398b", "rwkv6-3b", "whisper-medium",
            "internvl2-26b")


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k",
                                   "train_4k"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_counts_one_rank_on_two_pods(arch, shape):
    """At ``SMOKE_MULTIPOD_AXES`` (2 x 2 x 2) each family's pairs count
    one rank exactly, ``ok`` (whisper's long_500k skipped, as the
    reference's): the batch's rows over ("pod", "data") or "data", at
    long_500k's batch of 1 the rings over "data" in each pod, the
    weights' heads over "model"; the rank joins collectives on every
    pair."""
    rec = dryrun.run_one(arch, shape, smoke=True, multi_pod=True,
                         verbose=False)
    if not dryrun.resolve_mode(get_config(arch).reduced(), shape)[0]:
        assert rec["status"] == "skip"
        return
    assert rec["status"] == "ok", rec.get("error")
    assert rec["per_device_rule"] == "exact"
    assert rec["mesh_axes"] == dryrun.SMOKE_MULTIPOD_AXES
    assert rec["rank_coord"] == {"pod": 0, "data": 0, "model": 0}
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["roofline"]["collective_s"] > 0


@pytest.mark.parametrize("heads,m", [(3, 2), (7, 4)])
def test_a_ranks_count_follows_its_head_share(heads, m):
    """MLA heads that do not divide the model axis (deepseek's, reduced,
    with ``heads`` heads over ``m`` ranks): each coordinate counts the
    attention of the heads its columns touch (``model_axis.frac_heads``),
    3 over 2 two heads on each rank, 7 over 4 two, three, three and two:
    the prefill kernel's FLOPs a head are the same on every rank, and a
    rank with more heads counts more FLOPs in all."""
    recs = [dryrun.run_one("deepseek-v2-236b", "prefill_32k", smoke=True,
                           verbose=False, axes={"data": 1, "model": m},
                           coord={"model": r},
                           cfg_override={"num_heads": heads})
            for r in range(m)]
    assert all(r["status"] == "ok" for r in recs), recs[0].get("error")
    share = [-(-(r + 1) * heads // m) - r * heads // m for r in range(m)]
    assert share == ([2, 2] if m == 2 else [2, 3, 3, 2])
    per_head = {r["cost"]["kernel_flops"]["flash_attention"] / n
                for r, n in zip(recs, share)}
    assert len(per_head) == 1
    flops = [r["cost"]["flops"] for r in recs]
    for a in range(m):
        for b in range(m):
            if share[a] > share[b]:
                assert flops[a] > flops[b]
            elif share[a] == share[b]:
                assert flops[a] == flops[b]


# ---------------------------------------------------------------- meta route

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call,name,want", [
    (lambda: ops.kmeans_pairwise_dist(_meta(50, 8), _meta(3, 8)),
     "kmeans_pairwise_dist", kcost.kmeans_pairwise_dist(50, 8, 3)),
    (lambda: ops.kmeans_lloyd_step(_meta(50, 8), _meta(3, 8), _meta(50, 3)),
     "kmeans_lloyd_step", kcost.kmeans_lloyd_step(50, 8, 3)),
    (lambda: ops.quantize_affine(_meta(10, 64),
                                 _meta(10, dtype=torch.bool)),
     "quantize_affine", kcost.quantize_affine(10, 64)),
    (lambda: ops.quantize_affine_batched(_meta(3, 10, 64),
                                         _meta(3, 10, dtype=torch.bool)),
     "quantize_affine_batched", kcost.quantize_affine_batched(3, 10, 64)),
    (lambda: ops.flash_attention(_meta(1, 16, 4, 8, dtype=torch.bfloat16),
                                 _meta(1, 16, 2, 8, dtype=torch.bfloat16),
                                 _meta(1, 16, 2, 8, dtype=torch.bfloat16),
                                 window=5),
     "flash_attention", kcost.flash_attention(1, 16, 4, 2, 8, window=5)),
    (lambda: ops.flash_attention_bwd(
        *(_meta(1, 16, 4, 8) if i in (0, 3, 4) else _meta(1, 20, 2, 8)
          for i in range(5)), _meta(1, 4, 16), causal=False),
     "flash_attention_bwd",
     kcost.flash_attention_bwd(1, 16, 4, 2, 8, sk=20, causal=False,
                               dtype=torch.float32)),
    (lambda: ops.flash_decode(_meta(2, 1, 4, 8, dtype=torch.bfloat16),
                              _meta(2, 32, 2, 8, dtype=torch.bfloat16),
                              _meta(2, 32, 2, 8, dtype=torch.bfloat16),
                              _meta(2, 32, dtype=torch.bool)),
     "flash_decode", kcost.flash_decode(2, 32, 4, 2, 8)),
])
def test_the_meta_branch_charges_the_kernel_and_launches_nothing(call, name,
                                                                 want):
    """A meta call launches nothing (the wrappers' counts stay 0), runs no
    plain version (the count holds no aten product of its own), returns
    meta outputs and charges ``kernels/cost.py``'s count exactly."""
    ops.reset_launch_counts()
    with flop_analysis.counting() as sc:
        out = call()
    assert all(v == 0 for v in ops.launch_counts().values())
    for t in (out if isinstance(out, tuple) else (out,)):
        assert t.is_meta
    assert dict(sc.kernel_launches) == {name: 1}
    assert (sc.kernel_flops[name], sc.kernel_bytes[name]) == (
        want.flops, want.hbm_bytes)
    assert sc.flops == want.flops and sc.transcendentals == \
        want.transcendentals


def test_the_cpu_route_is_the_plain_version_still():
    """A CPU tensor still runs the plain version, bit for bit, and charges
    nothing, inside a count or not."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, 4, 8, generator=g),
               torch.randn(1, 16, 2, 8, generator=g),
               torch.randn(1, 16, 2, 8, generator=g))
    with flop_analysis.counting() as sc:
        got = ops.flash_attention(q, k, v)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v))
    assert not sc.kernel_launches and sc.flops > 0


def test_meta_selection_counts_one_lloyd_sweep_and_flags_it():
    """``select_metadata`` on meta tensors: first centres read as row 0,
    one Lloyd sweep counted and the count marked a lower bound, every
    K-means launch charged (9 farthest-point steps a class, one sweep,
    the empty-slot distances)."""
    from repro_torch.core import selection as sel
    n, classes, kk = 60, 3, 4
    with flop_analysis.counting() as sc:
        out = sel.select_metadata(_meta(n, 2, 2, 3),
                                  _meta(n, dtype=torch.int64),
                                  _meta(classes, dtype=torch.int64),
                                  num_classes=classes, clusters_per_class=kk,
                                  pca_components=5)
    assert out.indices.is_meta and tuple(out.indices.shape) == (classes * kk,)
    assert sc.unknown_trips == 1
    assert sc.kernel_launches["kmeans_lloyd_step"] == 1
    assert sc.kernel_launches["kmeans_pairwise_dist"] == classes * (kk - 1) + 1


@pytest.fixture
def production_mesh():
    """The 16 x 16 mesh over a fake world of 256 ranks (this process rank
    0): the step makers' checks and the placements, no collective."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    yield make_production_mesh(device_type="cpu")
    dist.destroy_process_group()


def _meta_cache(lm, mesh, shape, seq_shard):
    """``cache_on_mesh``'s DTensor cache at ``shape`` on meta tensors."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import _cache_placements
    shapes = lm.init_cache(shape.global_batch, shape.seq_len,
                           device="meta")
    placements = _cache_placements(lm.cfg, mesh, shapes, shape.global_batch,
                                   seq_shard)

    def one(x, pl):
        local = list(x.shape)
        for i, p in enumerate(pl):
            if not p.is_replicate():
                local[p.dim] //= mesh.size(i)
        return DTensor.from_local(
            torch.empty(local, dtype=x.dtype, device="meta"), mesh, pl,
            run_check=False, shape=x.shape, stride=x.stride())
    return sh.map_with_placements(one, shapes, placements)


@pytest.mark.parametrize("arch", ARCHS)
def test_production_decode_and_fsdp_steps_pass_the_step_checks(
        production_mesh, arch):
    """At the 16 x 16 axes, meta only: every arch's decode_32k and
    long_500k (as ``resolve_mode`` runs them), with and without
    ``cache_seq_shard``, builds its decode step and its cache on
    ``cache_plan``'s placements (the head dim over "model" where the kv
    heads do not divide 16, the sequence over "data" at long_500k's
    batch of 1, over "model" or ("data", "model") with
    ``cache_seq_shard``), which the step's checks take and whose split
    rings the step reads (``steps._rings``); jamba's and deepseek's train,
    prefill and decode steps build with their weights over "data"
    (FSDP). What still raises does so in the layers (RWKV or MLA heads
    that do not divide 16: ``model_axis.even_share``)."""
    from repro_torch.launch.specs import check_cache_placements, step_plan
    from repro_torch.launch.mesh import mesh_axis_sizes
    cfg = get_config(arch)
    axes = mesh_axis_sizes(production_mesh)
    seen = set()
    for shape_name in ("decode_32k", "long_500k"):
        ok, force_swa, _ = dryrun.resolve_mode(cfg, shape_name)
        if not ok:
            continue
        shape = INPUT_SHAPES[shape_name]
        for seq_shard in (False, True):
            _, lm = steps.make_decode_step(cfg, force_swa=force_swa,
                                           mesh=production_mesh,
                                           cache_seq_shard=seq_shard)
            cache = _meta_cache(lm, production_mesh, shape, seq_shard)
            check_cache_placements(cfg, production_mesh, cache,
                                   shape.global_batch, seq_shard)
            seen |= {r.axes for st in steps._rings(cache, production_mesh)
                     for r in st if r is not None}
    if arch == "rwkv6-3b":                    # no ring, states only
        assert not seen
    elif arch == "whisper-medium":            # no long_500k
        assert seen == {("model",)}
    elif arch != "jamba-1.5-large-398b" or seen:
        assert seen == {("model",), ("data",), ("data", "model")}
    if arch in ("jamba-1.5-large-398b", "deepseek-v2-236b"):
        steps.make_train_step(cfg, TrainConfig(), mesh=production_mesh)
        steps.make_prefill_step(cfg, mesh=production_mesh)
        plan = step_plan(cfg, axes, "decode")
        assert plan.notes == ["fsdp: second weight dim sharded over 'data'"]
