"""The port's sharding planner (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), leaf by leaf, on the CPU.

Every arch of ``repro.configs.ARCHS`` at full size (shapes only: the
reference's ``jax.eval_shape`` of ``LM.init`` beside the port's meta
tensors), on the (16, 16) ("data", "model") and (2, 16, 16) ("pod",
"data", "model") production meshes and the (2, 2) smoke mesh. The
reference's mesh is a stand-in: an ``AbstractMesh`` that also answers
``devices`` with an empty array of the mesh's shape (the planner reads
only its axis names and sizes), so no device exists; the port's planner
takes the same sizes as a dict.

Layouts: the train layout (the cohort axis stacked and carried by
``fed_layout``'s axes) with ``head_aware`` on and off; prefill (bf16
shapes, head-aware off) and decode (head-aware on). ``cache_plan`` for
every arch's decode cache at ``decode_32k`` (batch 128) and at
``long_500k``'s batch 1, ``seq_shard`` on and off.

Level: exact. Every leaf's spec, ``Plan.replicated`` (in order) and
``Plan.notes``; the cache trees' shapes too.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ARCHS, INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.launch import sharding as jsh
from repro.launch.specs import fed_layout as jfed_layout
from repro.models.transformer import LM as JLM
from repro_torch.configs import get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch.specs import fed_layout
from repro_torch.models.transformer import LM

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


class StandInMesh(AbstractMesh):
    """The reference planner's mesh without devices."""

    @property
    def devices(self):
        return np.empty(tuple(self.axis_sizes), object)


def stand_in(mesh: str):
    shape, names = MESHES[mesh]
    return StandInMesh(shape, names), dict(zip(names, shape))


def sorted_leaves(tree):
    """The leaves of nested dicts and lists in ``jax.tree_util``'s order
    (dict keys sorted); a spec tuple is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def jspecs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


@functools.lru_cache(maxsize=None)
def shapes(arch):
    """(reference ShapeDtypeStructs, port meta tensors) of the f32 tree."""
    jtree = jax.eval_shape(JLM(jget_config(arch)).init, jax.random.PRNGKey(0))
    tree = LM(get_config(arch)).init(None, device="meta")
    return jtree, tree


def _stack(jtree, tree, g):
    return (jax.tree.map(lambda s: jax.ShapeDtypeStruct((g,) + s.shape,
                                                        s.dtype), jtree),
            _meta_stack(tree, g))


def _meta_stack(tree, g):
    if isinstance(tree, dict):
        return {k: _meta_stack(v, g) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta_stack(v, g) for v in tree]
    return torch.empty((g,) + tuple(tree.shape), device="meta")


def _same_plan(got, want):
    assert sorted_leaves(got.params) == jspecs(want.params)
    assert got.replicated == want.replicated
    assert got.notes == want.notes


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_plan_params_matches_the_reference(arch, mesh):
    jmesh, axes = stand_in(mesh)
    jtree, tree = shapes(arch)
    jcfg, cfg = jget_config(arch), get_config(arch)
    # the shapes themselves, leaf by leaf
    assert [tuple(t.shape) for t in sorted_leaves(tree)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jtree)]
    # train: the cohort axis over the fed axes, head-aware both ways
    g, fed_axes = fed_layout(cfg, axes)
    assert (g, fed_axes) == jfed_layout(jcfg, jmesh)
    jst, st = _stack(jtree, tree, g)
    for head_aware in (False, True):
        _same_plan(sh.plan_params(cfg, axes, st, fed_axes=fed_axes,
                                  head_aware=head_aware),
                   jsh.plan_params(jcfg, jmesh, jst, fed_axes=fed_axes,
                                   head_aware=head_aware))
    # prefill (head-aware off) and decode (on), over unstacked weights
    for head_aware in (False, True):
        _same_plan(sh.plan_params(cfg, axes, tree, head_aware=head_aware),
                   jsh.plan_params(jcfg, jmesh, jtree,
                                   head_aware=head_aware))
    assert sh.batch_spec(axes) == jsh.batch_spec(jmesh)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_plan_matches_the_reference(arch, shape):
    jcfg, cfg = jget_config(arch), get_config(arch)
    sc = INPUT_SHAPES[shape]
    jcache = jax.eval_shape(lambda: JLM(jcfg).init_cache(
        sc.global_batch, sc.seq_len, dtype=jnp.bfloat16))
    cache = LM(cfg).init_cache(sc.global_batch, sc.seq_len,
                               dtype=torch.bfloat16, device="meta")
    assert [tuple(t.shape) for t in sorted_leaves(cache)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jcache)]
    for mesh in sorted(MESHES):
        jmesh, axes = stand_in(mesh)
        for seq_shard in (False, True):
            got = sh.cache_plan(cfg, axes, cache, sc.global_batch,
                                seq_shard=seq_shard)
            want = jsh.cache_plan(jcfg, jmesh, jcache, sc.global_batch,
                                  seq_shard=seq_shard)
            assert sorted_leaves(got) == jspecs(want), (mesh, seq_shard)


def test_fsdp_is_planned_for_the_huge_archs():
    """Above the threshold the plan shards a second weight dim over
    "data" and says so; below it does not."""
    axes = dict(zip(*reversed(MESHES["16x16"])))
    for arch, huge in [("deepseek-v2-236b", True),
                       ("jamba-1.5-large-398b", True),
                       ("llama3.2-1b", False)]:
        plan = sh.plan_params(get_config(arch), axes, shapes(arch)[1])
        assert bool(plan.notes) == huge
        assert any("data" in s for s in sorted_leaves(plan.params)) == huge
