"""Input specs: the port of ``repro.launch.specs``. For every (arch x
input shape x mesh) it gives what a step takes (parameters, optimizer
state, batch, caches), each as a ``Placed``: a tensor on the ``meta``
device (shape and dtype, no storage) beside its spec.

Shapes come without a generator: ``LM.init(None, device="meta")`` and
``LM.init_cache(..., device="meta")`` make empty meta tensors and draw
nothing, and the batch's tensors are ``torch.empty`` on the meta device.
Nothing here allocates memory or needs a device, so the production
mesh's specs are computed from its axis sizes alone
(``launch.mesh.mesh_axis_sizes``).

What a step executes on a mesh takes the same plans: ``step_plan`` is the
parameters' plan of a step kind (as ``input_specs`` plans it), which
``sharding.distribute_tree`` places (``params_on_mesh`` draws it there,
each rank keeping its shards only); ``cache_on_mesh`` makes a decode
cache as DTensors on ``cache_plan``'s placements (each rank allocating
its own shard only: k/v, MLA's latent, Mamba's and RWKV's states; a ring
split on its kv heads, its head dim or its sequence), and
``check_cache_placements`` holds a cache to them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch.sharding import Placed
from repro_torch.models.transformer import LM

PyTree = Any


def _meta(shape, dtype, spec) -> Placed:
    return Placed(torch.empty(tuple(shape), dtype=dtype, device="meta"),
                  tuple(spec))


def _with_specs(shapes: PyTree, specs: PyTree) -> PyTree:
    if isinstance(shapes, dict):
        return {k: _with_specs(v, specs[k]) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [_with_specs(v, s) for v, s in zip(shapes, specs)]
    return Placed(shapes, specs)


def fed_layout(cfg: ModelConfig, axes: sh.Axes
               ) -> Tuple[int, Tuple[str, ...]]:
    """(G cohorts, the mesh axes that carry them) for the train step: the
    "data" axis, with "pod" before it on two pods; above
    ``FSDP_THRESHOLD`` parameters "data" shards the weights, so only the
    pods carry cohorts."""
    from repro_torch.models.registry import count_params
    huge = count_params(cfg) > sh.FSDP_THRESHOLD
    p_ax, d_ax = axes.get("pod", 1), axes.get("data", 1)
    if huge:
        return (p_ax, ("pod",)) if p_ax > 1 else (1, ())
    if p_ax > 1:
        return p_ax * d_ax, ("pod", "data")
    return d_ax, ("data",)


def param_specs(cfg: ModelConfig, axes: sh.Axes, lm: Optional[LM] = None,
                fed_axes: Optional[Tuple[str, ...]] = None, g: int = 0,
                param_dtype=torch.float32, head_aware: bool = True):
    """-> (the parameter tree as ``Placed`` leaves, its ``Plan``); with
    ``fed_axes`` and ``g`` > 0 every leaf has a leading cohort axis G."""
    lm = lm or LM(cfg)
    shapes = lm.init(None, device="meta", dtype=param_dtype)
    stacked = fed_axes is not None and g > 0
    if stacked:
        shapes = _stack(shapes, g)
    plan = sh.plan_params(cfg, axes, shapes,
                          fed_axes=fed_axes if stacked else None,
                          head_aware=head_aware)
    return _with_specs(shapes, plan.params), plan


def _stack(shapes: PyTree, g: int) -> PyTree:
    if isinstance(shapes, dict):
        return {k: _stack(v, g) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [_stack(v, g) for v in shapes]
    return torch.empty((g,) + tuple(shapes.shape), dtype=shapes.dtype,
                       device="meta")


def _extras_specs(cfg: ModelConfig, lead: tuple, lead_spec: tuple,
                  dtype=torch.bfloat16) -> Dict[str, Placed]:
    """The stub front ends' inputs: a VLM's patch embeddings, an
    encoder-decoder's frames."""
    ex = {}
    if cfg.frontend == "vision_stub":
        ex["prefix_embeds"] = _meta(
            lead + (cfg.num_prefix_tokens, cfg.d_model), dtype,
            lead_spec + (None, None))
    if cfg.frontend == "audio_stub":
        ex["enc_frames"] = _meta(lead + (cfg.encoder_seq_len, cfg.d_model),
                                 dtype, lead_spec + (None, None))
    return ex


def input_specs(cfg: ModelConfig, shape: ShapeConfig, axes: sh.Axes,
                tcfg: Optional[TrainConfig] = None,
                force_swa: bool = False, lm: Optional[LM] = None,
                cache_seq_shard: bool = False) -> Dict[str, Any]:
    """Everything a step takes for (arch, shape, mesh axes), as
    ``Placed`` leaves, with the plan. ``lm`` must be the step's own LM
    where its stages differ from the default (the train step splits them
    at the paper's layer j).

    Train: params (G, ...) f32, opt_state () (plain SGD), batch
    {"tokens": (G, L, n_micro, mb, T) int32, and the extras}, and "first"
    (G,) int64, each cohort's K-means first centre, which the port's step
    takes where the reference's takes a key; with "g" and "fed_axes".
    Prefill: bf16 params, batch {"tokens": (B, S)} and extras. Decode:
    bf16 params, the bf16 cache and tokens (B, 1)."""
    tcfg = tcfg or TrainConfig()
    p_ax, d_ax = axes.get("pod", 1), axes.get("data", 1)

    if shape.kind == "train":
        g, fed_axes = fed_layout(cfg, axes)
        lm = lm or LM(cfg, remat=tcfg.remat)
        # head-aware replication is right for training only with
        # sequence-sharded activations
        params, plan = param_specs(cfg, axes, lm, fed_axes=fed_axes, g=g,
                                   head_aware=tcfg.seq_shard_activations)
        cohort_batch = max(shape.global_batch // max(g, 1), 1)
        mb = min(tcfg.microbatch, cohort_batch)
        n_micro = max(cohort_batch // mb, 1)
        lead = (g, tcfg.local_steps, n_micro, mb)
        # the cohort axis over the fed axes; a cohort's rows over any batch
        # axis the cohorts do not use (FSDP: rows over "data")
        row_axes = tuple(a for a in ("data",)
                         if a not in fed_axes and axes.get(a, 1) > 1
                         and mb % axes.get(a, 1) == 0)
        fed_spec = (fed_axes if len(fed_axes) > 1 else
                    (fed_axes[0] if fed_axes else None),)
        lead_spec = fed_spec + (None, None,
                                row_axes if len(row_axes) > 1 else
                                (row_axes[0] if row_axes else None))
        batch = {"tokens": _meta(lead + (shape.seq_len,), torch.int32,
                                 lead_spec + (None,))}
        batch.update(_extras_specs(cfg, lead, lead_spec))
        first = _meta((g,), torch.int64, (None,))
        return dict(mode="train", params=params, opt_state=(), batch=batch,
                    first=first, plan=plan, g=g, fed_axes=fed_axes)

    # inference: head-aware replication is right for decode (fractional
    # heads' resharding dominates the tiny attention) and wrong for
    # prefill (replicated quadratic attention on every model rank)
    lm = lm or LM(cfg, force_swa=force_swa)
    params, plan = param_specs(cfg, axes, lm, param_dtype=torch.bfloat16,
                               head_aware=(shape.kind == "decode"))
    b = shape.global_batch
    if p_ax > 1 and b % (p_ax * d_ax) == 0:
        bspec: Any = ("pod", "data")
    elif b % d_ax == 0 and d_ax > 1:
        bspec = "data"
    else:
        bspec = None

    if shape.kind == "prefill":
        batch = {"tokens": _meta((b, shape.seq_len), torch.int32,
                                 (bspec, None))}
        batch.update(_extras_specs(cfg, (b,), (bspec,)))
        return dict(mode="prefill", params=params, batch=batch, plan=plan)

    # decode: ONE new token against a seq_len cache
    cache_shapes = lm.init_cache(b, shape.seq_len, dtype=torch.bfloat16,
                                 device="meta")
    cplan = sh.cache_plan(cfg, axes, cache_shapes, b,
                          seq_shard=cache_seq_shard)
    return dict(mode="decode", params=params,
                cache=_with_specs(cache_shapes, cplan),
                tokens=_meta((b, 1), torch.int32, (bspec, None)), plan=plan)


# --------------------------------------------------------------------------
# the plans a step executes
# --------------------------------------------------------------------------
def step_plan(cfg: ModelConfig, axes: sh.Axes, kind: str,
              tcfg: Optional[TrainConfig] = None, lm: Optional[LM] = None,
              g: int = 0) -> sh.Plan:
    """The parameters' plan of a step ``kind`` ("train", "prefill" or
    "decode") on a mesh of ``axes``, as ``input_specs`` plans it: the
    train step's G-stacked tree (``g`` cohorts over the fed axes; ``lm``
    the step's own, split at layer j), head-aware by
    ``tcfg.seq_shard_activations``; prefill's plain tree with the flat
    heads sharded, decode's head-aware (serving one tree through both
    takes decode's)."""
    if kind == "train":
        tcfg = tcfg or TrainConfig()
        _, fed_axes = fed_layout(cfg, axes)
        return param_specs(cfg, axes, lm or LM(cfg, remat=tcfg.remat),
                           fed_axes=fed_axes, g=g,
                           head_aware=tcfg.seq_shard_activations)[1]
    if kind not in ("prefill", "decode"):
        raise ValueError(f"unknown step kind {kind!r}")
    return param_specs(cfg, axes, lm or LM(cfg),
                       head_aware=kind == "decode")[1]


def _cache_placements(cfg: ModelConfig, mesh, shapes: PyTree,
                      batch: int, seq_shard: bool = False) -> PyTree:
    from repro_torch.launch.mesh import mesh_axis_sizes
    axes = mesh_axis_sizes(mesh)
    specs = sh.cache_plan(cfg, axes, shapes, batch, seq_shard=seq_shard)
    names = tuple(mesh.mesh_dim_names)
    return sh.tree_map_specs(lambda s: sh.to_placements(s, names), specs)


def params_on_mesh(lm: LM, gen: torch.Generator, placements, mesh,
                   dtype=torch.float32, device=None) -> PyTree:
    """``sharding.distribute_tree(lm.init(gen, device, dtype),
    placements, mesh)`` without the whole tree: each leaf is drawn as
    ``lm.init`` draws it (the same calls on ``gen``, so the same bits) and
    cut to this rank's part at once, so a rank holds its shards and one
    whole layer slice at most (jamba's 4-layer cut is 23 B parameters,
    46 GB in bf16). ``placements`` a ``Plan`` or a tree of placement
    tuples."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.models import layers as L
    if isinstance(placements, sh.Plan):
        placements = placements.placements(mesh)
    # which leaf each of ``init``'s calls makes, from a meta draw
    calls: list = []

    class Recorder(L.ParamInit):
        def normal(self, shape, scale):
            calls.append(super().normal(shape, scale))
            return calls[-1]

        def full(self, shape, value):
            calls.append(super().full(shape, value))
            return calls[-1]

    shapes = lm.draw(Recorder(None, "meta", dtype=dtype))
    order = {id(t): i for i, t in enumerate(calls)}
    by_call: list = [None] * len(calls)
    sh.map_with_placements(
        lambda x, pl: by_call.__setitem__(order[id(x)], pl), shapes,
        placements)
    coord = mesh.get_coordinate()
    at = iter(by_call)

    def cut(x, pl, skip=0):
        """This rank's part of ``x`` under placements ``pl`` (whose dims
        count ``skip`` leading dims ``x`` does not have)."""
        for mdim, p in enumerate(pl):
            if isinstance(p, Shard):
                size = x.shape[p.dim - skip] // mesh.size(mdim)
                x = x.narrow(p.dim - skip, coord[mdim] * size, size)
        return x

    class Sharder(L.ParamInit):
        def normal(self, shape, scale):
            pl, lead = next(at), len(self.lead)
            if any(isinstance(p, Shard) and p.dim < lead for p in pl):
                raise ValueError("params_on_mesh: a plan that splits a "
                                 "stacked layer axis")
            # each layer slice drawn whole in f32, as ``ParamInit.normal``
            # draws it, and cut before it is cast: no whole leaf in
            # ``dtype`` is ever made
            out = torch.empty(self.lead + tuple(cut(torch.empty(
                shape, device="meta"), pl, lead).shape), dtype=self.dtype,
                device=self.device)
            flat = out.view((-1,) + tuple(out.shape[lead:]))
            for r in range(flat.shape[0]):
                x = torch.randn(shape, generator=self.gen,
                                device=self.gen.device)
                flat[r].copy_(cut(x.mul_(scale), pl, lead))
            return out

        def full(self, shape, value):
            x = super().full(shape, value)
            local = cut(x, next(at))
            return local if local is x else local.clone(
                memory_format=torch.contiguous_format)

    local = lm.draw(Sharder(gen, device, dtype=dtype))
    return sh.map_with_placements(
        lambda x, pl: DTensor.from_local(x, mesh, tuple(pl),
                                         run_check=False),
        local, placements)


def cache_on_mesh(lm: LM, mesh, batch: int, seq_len: int,
                  dtype=torch.bfloat16, device=None,
                  seq_shard: bool = False) -> PyTree:
    """``lm.init_cache(batch, seq_len)`` as DTensors on ``cache_plan``'s
    placements over ``mesh`` (``seq_shard``: the reference's
    ``cache_seq_shard``, the rings' sequence over "model"): each rank
    allocates its own shard (zeros) only."""
    from torch.distributed.tensor import DTensor, Shard
    shapes = lm.init_cache(batch, seq_len, dtype=dtype, device="meta")
    placements = _cache_placements(lm.cfg, mesh, shapes, batch, seq_shard)

    def one(x, pl):
        shape = list(x.shape)
        for mdim, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim] //= mesh.size(mdim)
        local = torch.zeros(shape, dtype=x.dtype, device=device)
        return DTensor.from_local(local, mesh, tuple(pl), run_check=False,
                                  shape=x.shape, stride=x.stride())
    return sh.map_with_placements(one, shapes, placements)


def check_cache_placements(cfg: ModelConfig, mesh, cache: PyTree,
                           batch: int, seq_shard: bool = False) -> PyTree:
    """``cache``'s placements, which must be ``cache_plan``'s for its
    shapes on ``mesh`` (with ``seq_shard`` as ``cache_on_mesh``'s;
    ``ValueError`` otherwise)."""
    shapes = _meta_like(cache)
    want = _cache_placements(cfg, mesh, shapes, batch, seq_shard)
    got = sh.placements_of(cache)
    if got != want:
        raise ValueError("decode on a mesh takes its cache as DTensors on "
                         "cache_plan's placements (specs.cache_on_mesh)")
    return got


def _meta_like(tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta_like(v) for v in tree]
    return torch.empty(tuple(tree.shape), dtype=tree.dtype, device="meta")
