"""Sharding planner: the port of ``repro.launch.sharding``. It maps every
parameter, batch and cache leaf to a spec for the production mesh, by leaf
name and divisibility.

A spec is a tuple with one entry per tensor dim: None (replicated), a
mesh axis name, or a tuple of axis names (the dim split over all of
them, major first): the content of the reference's ``PartitionSpec``.
``Plan.placements`` turns one into DTensor placements on a
``DeviceMesh``.

Strategies, as the reference's:
  * tp   — tensor parallel on "model" (column- or row-parallel by leaf
           kind); experts on "model" for an MoE. Every mode uses it.
  * fsdp — also shard a second weight dim over "data" for the archs above
           ``FSDP_THRESHOLD`` parameters (jamba 398B, deepseek 236B).
  * fed  — the stacked cohort axis (leading G) over "data" and/or "pod"
           for the FedAvg train step.

A dim that does not divide its axis stays replicated, and the plan
records it. The planners take axis sizes (``launch.mesh.mesh_axis_sizes``),
so a plan needs no devices. ``launch/steps.py`` executes the fed axis,
the model axis for every family (tensor parallel, the experts over
"model" expert parallel: ``models/model_axis.py``), FSDP
(``models/fsdp.py``), every cache plan (a k/v ring split on its head
dim or its sequence, a latent ring on its sequence), heads split
mid-head (a rank computes the heads its columns touch) and the train
step's sequence-sharded activations.

``distribute_tree`` puts a tree of full tensors (every rank holding the
same) on a plan's placements as DTensors, each rank keeping its own part
with no collective; ``gather_tree`` gathers a DTensor tree back to full
tensors through ``core/collectives.py`` (device copies between the
ranks of one card, host-staged across cards under gloo, which gathers
no CUDA tensor); ``local_tree`` and ``wrap_tree`` go between a
DTensor tree and its local tensors.

The parameter trees are the port's (``LM.init``), which carry the
reference's leaf names; leaves are walked as the reference's
``jax.tree_util`` walks them (dict keys sorted), so ``Plan.replicated``
lists them in its order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Tuple)

import torch

from repro_torch.configs.base import ModelConfig

PyTree = Any
Spec = Tuple[Any, ...]
Axes = Mapping[str, int]


class Placed(NamedTuple):
    """A meta tensor (its shape and dtype) beside its spec (one entry a
    dim: None, an axis name or a tuple of axis names). ``launch/specs.py``
    gives whole tensors; the dry run gives one rank's shards, so that a
    step reads the spec as it reads a DTensor's placements."""
    tensor: torch.Tensor
    spec: Spec

FSDP_THRESHOLD = 40e9   # params; above this weights also shard over "data"

# leaf name -> which dim prefers the model axis: col = the output/feature
# dim, row = the reduction dim (row-parallel => a sum over the axis)
_COL = {"wq", "wk", "wv", "wg", "cwq", "cwk", "cwv", "w_gate", "w_up",
        "ws_gate", "ws_up", "w_uq", "w_uk", "w_uv", "w_in", "w_dt",
        "w_decay2", "wr", "lm_head", "wk_ffn"}
_ROW = {"wo", "cwo", "w_down", "ws_down", "w_out", "w_x", "wv_ffn"}
_EXPERT = {"we_gate", "we_up", "we_down"}
_REPLICATE = {"router", "w_dq", "w_dkv", "w_kr", "q_norm", "kv_norm",
              "conv_w", "conv_b", "bonus", "mu_r", "mu_k", "mu_v", "mu_w",
              "mu_g", "w_decay1", "decay_bias", "dt_bias", "A_log", "D",
              "ln_x", "norm", "cross_norm", "final_norm", "enc_norm", "proj",
              "scale", "bias", "fc_b", "bq", "bk", "bv"}


@dataclass
class Plan:
    """A spec tree matching the parameters (``params``), the leaf names
    left replicated where they would have sharded, and notes."""
    axes: Dict[str, int]
    params: PyTree = None
    replicated: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)

    def placements(self, mesh) -> PyTree:
        """The spec tree as DTensor placements on ``mesh`` (a
        ``DeviceMesh`` with this plan's axis sizes): one tuple a leaf, a
        ``Shard(dim)`` or ``Replicate()`` a mesh dim."""
        from repro_torch.launch.mesh import mesh_axis_sizes
        if mesh_axis_sizes(mesh) != dict(self.axes):
            raise ValueError(f"the plan is for {dict(self.axes)}, the mesh "
                             f"is {mesh_axis_sizes(mesh)}")
        names = tuple(mesh.mesh_dim_names)
        return tree_map_specs(lambda s: to_placements(s, names),
                              self.params)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def map_with_placements(fn: Callable, tree: PyTree,
                        placements: PyTree) -> PyTree:
    """``fn(leaf, its placements)`` over a tensor tree and a tree of
    placement tuples of the same structure (a tuple there is a leaf's)."""
    if isinstance(tree, dict):
        if set(tree) != set(placements):
            raise ValueError(f"keys {sorted(tree)} where the placements "
                             f"have {sorted(placements)}")
        return {k: map_with_placements(fn, v, placements[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(placements):
            raise ValueError(f"a list of {len(tree)} where the placements "
                             f"have {len(placements)}")
        return type(tree)(map_with_placements(fn, v, p)
                          for v, p in zip(tree, placements))
    return None if tree is None else fn(tree, placements)


def distribute_tree(tree: PyTree, placements: PyTree, mesh) -> PyTree:
    """Every full leaf of ``tree`` as a DTensor on ``mesh`` with its
    placements (a ``Plan``, or a tree of placement tuples): each rank keeps
    a contiguous copy of its own part, its coordinate's even chunk of every
    sharded dim (the plan shards only dims that divide). Every rank must
    hold the same tree; nothing is sent."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(placements, Plan):
        placements = placements.placements(mesh)
    coord = mesh.get_coordinate()

    def one(x, pl):
        local = x
        for mdim, p in enumerate(pl):
            if isinstance(p, Shard):
                size = local.shape[p.dim] // mesh.size(mdim)
                local = local.narrow(p.dim, coord[mdim] * size, size)
        return DTensor.from_local(
            local.clone(memory_format=torch.contiguous_format), mesh,
            tuple(pl), run_check=False, shape=x.shape,
            stride=torch.empty(x.shape, device="meta").stride())
    return map_with_placements(one, tree, placements)


def gather_tree(tree: PyTree) -> PyTree:
    """Every DTensor leaf gathered to its full tensor on every rank, bit
    for bit (a plain leaf is returned as it is)."""
    from torch.distributed.tensor import Shard
    from repro_torch.core.collectives import Ranks, all_gather_cat
    from repro_torch.optim.optimizers import tree_map

    def one(x):
        if not _is_dtensor(x):
            return x
        out, mesh = x.to_local(), x.device_mesh
        # minor mesh dims first: a dim split over several axes holds the
        # major axis's chunks of the minor's
        for mdim in reversed(range(mesh.ndim)):
            p = x.placements[mdim]
            if isinstance(p, Shard) and mesh.size(mdim) > 1:
                out = all_gather_cat(out, Ranks.of(mesh.get_group(mdim)),
                                     p.dim)
        return out
    return tree_map(one, tree)


def holds_dtensors(tree: PyTree) -> bool:
    """Whether any leaf of ``tree`` is a DTensor."""
    from repro_torch.optim.optimizers import tree_leaves
    return any(_is_dtensor(x) for x in tree_leaves(tree))


def local_tree(tree: PyTree) -> PyTree:
    """Each DTensor leaf's local tensor, each ``Placed`` leaf's tensor (a
    plain leaf as it is)."""
    def one(x):
        if isinstance(x, Placed):
            return x.tensor
        return x.to_local() if _is_dtensor(x) else x
    return map_leaves(one, tree)


def map_leaves(fn: Callable, tree: PyTree) -> PyTree:
    """``fn`` on every leaf of nested dicts, lists and tuples, a
    ``Placed`` a leaf; None stays None."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Placed):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def split_axes(x) -> Dict[int, Tuple[str, ...]]:
    """{tensor dim: the mesh axes that split it, in the mesh's order} of a
    leaf: from a DTensor's placements or a ``Placed``'s spec; {} for a
    plain tensor. Axes of size 1 are named too."""
    out: Dict[int, Tuple[str, ...]] = {}
    if isinstance(x, Placed):
        for dim, entry in enumerate(x.spec):
            if entry is not None:
                out[dim] = (entry,) if isinstance(entry, str) else tuple(entry)
    elif _is_dtensor(x):
        names = x.device_mesh.mesh_dim_names
        for mdim, p in enumerate(x.placements):
            if p.is_shard():
                out[p.dim] = out.get(p.dim, ()) + (names[mdim],)
    return out


def leaf_ndim(x) -> int:
    return x.tensor.ndim if isinstance(x, Placed) else x.ndim


def placements_of(tree: PyTree) -> PyTree:
    """Each leaf's placements: a DTensor's, () for a plain tensor."""
    def one(x):
        return tuple(x.placements) if _is_dtensor(x) else ()
    if isinstance(tree, dict):
        return {k: placements_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(placements_of(v) for v in tree)
    return None if tree is None else one(tree)


def wrap_tree(local: PyTree, placements: PyTree, mesh) -> PyTree:
    """Local tensors back into DTensors on ``mesh`` with ``placements``
    (``placements_of``'s tree); a leaf with no placements stays plain."""
    from torch.distributed.tensor import DTensor
    return map_with_placements(lambda x, p: DTensor.from_local(
        x, mesh, tuple(p), run_check=False) if p else x, local, placements)


def to_placements(spec: Spec, mesh_axes: Tuple[str, ...]) -> tuple:
    """One spec -> a placement a mesh dim. A tensor dim split over several
    axes must name them in the mesh's order (major first), as every spec
    of this planner does."""
    from torch.distributed.tensor import Replicate, Shard
    out: List[Any] = [Replicate()] * len(mesh_axes)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [mesh_axes.index(n) for n in names]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: dim {dim} names {names} out of "
                             f"the mesh's order {mesh_axes}")
        for p in pos:
            out[p] = Shard(dim)
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(n, str) for n in e))
        for e in x)


def tree_map_specs(fn: Callable, tree: PyTree) -> PyTree:
    """``fn`` on every spec of a spec tree (dicts and lists of specs)."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_specs(fn, v) for v in tree]
    if _is_spec(tree):
        return fn(tree)
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def map_with_path(fn: Callable, tree: PyTree, path: Tuple = ()) -> PyTree:
    """``fn(path, leaf)`` on every tensor leaf of nested dicts and lists,
    dict keys walked in sorted order (``jax.tree_util``'s); ``path`` holds
    the keys and list indices down to the leaf. The tree's structure and
    key order are kept."""
    if isinstance(tree, dict):
        done = {k: map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _leaf_name(path) -> str:
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def plan_params(cfg: ModelConfig, axes: Axes, params_shapes: PyTree, *,
                fed_axes: Optional[Tuple[str, ...]] = None,
                fsdp: Optional[bool] = None,
                head_aware: bool = True) -> Plan:
    """Specs for a parameter tree (of tensors with shapes: meta tensors
    will do) on a mesh of ``axes`` sizes.

    fed_axes:   mesh axes carrying the stacked cohort axis (train mode);
                the tree then has that extra LEADING axis.
    fsdp:       shard a second weight dim over "data" (default: above
                ``FSDP_THRESHOLD`` parameters).
    head_aware: replicate attention weights when the heads do not divide
                the model axis (no fractional heads a device). Right for
                inference and for training with sequence-sharded
                activations; wrong for plain training (replicated
                attention repeats its compute on every model rank).
    """
    m = axes.get("model", 1)
    d_axis = axes.get("data", 1)
    if fsdp is None:
        from repro_torch.models.registry import count_params
        fsdp = count_params(cfg) > FSDP_THRESHOLD
    use_data_dim = fsdp and "data" not in (fed_axes or ())
    plan = Plan(dict(axes))
    if fsdp:
        plan.notes.append("fsdp: second weight dim sharded over 'data'")

    def spec_for(path, leaf) -> Spec:
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        # rwkv's channel mix reuses wk/wv/wr with transposed roles
        if ("ffn" in "/".join(map(str, path))
                and name in ("wk", "wv", "wr")):
            name = {"wk": "wk_ffn", "wv": "wv_ffn", "wr": "wr_ffn"}[name]
        # leading stacking axes (scan repeats, the cohort axis)
        nstack = max(len(shape) - _base_ndim(name), 0)
        base = _base_spec(cfg, name, shape[nstack:], m,
                          d_axis if use_data_dim else 0, plan,
                          head_aware=head_aware)
        spec: List[Any] = [None] * nstack + base
        if fed_axes:
            # leading axis 0 is the cohort axis
            spec[0] = fed_axes if len(fed_axes) > 1 else fed_axes[0]
        return tuple(spec)

    plan.params = map_with_path(spec_for, params_shapes)
    return plan


def _base_ndim(name: str) -> int:
    """ndim of the leaf BEFORE any stacking (scan repeats, cohorts)."""
    if name in _EXPERT:
        return 3
    if name in ("embed", "lm_head", "fc_w", "embed_head"):
        return 2
    if name in _COL | _ROW | {"w_decay1", "w_dkv", "w_kr", "w_dq", "proj",
                              "wr_ffn"}:
        return 2
    if name in ("conv_w", "A_log", "bonus"):
        return 2
    if name in ("conv_in", "conv1", "conv2", "shortcut"):
        return 4
    return 1   # norms, biases, mus


_ATTN_HEADED = {"wq", "cwq", "wg", "wr", "bq"}       # num_heads-shaped
_ATTN_KV_HEADED = {"wk", "wv", "cwk", "cwv", "bk", "bv"}  # kv-heads-shaped
_ATTN_OUT = {"wo", "cwo"}


def _base_spec(cfg: ModelConfig, name: str, shape, m: int, d_axis: int,
               plan: Plan, head_aware: bool = True) -> List[Any]:
    """Spec entries of the unstacked leaf."""
    def div(i, ax):
        return ax > 1 and shape[i] % ax == 0

    # head-aware: sharding the FLAT h*hd dim when the heads do not divide
    # the axis puts fractional heads on each device, and every (b,s,h,hd)
    # reshape then gathers; replicate the attention weights instead (FFN
    # and vocab still shard)
    if head_aware:
        heads_ok = cfg.num_heads % m == 0
        kv_ok = cfg.num_kv_heads % m == 0
        if ((name in _ATTN_HEADED and not heads_ok)
                or (name in _ATTN_KV_HEADED and not kv_ok)
                or (name in _ATTN_OUT and not heads_ok)):
            plan.replicated.append(name)
            return [None] * len(shape)

    dims: List[Any] = [None] * len(shape)
    if name in ("embed", "embed_head"):
        if div(0, m):
            dims[0] = "model"
        if d_axis and div(1, d_axis):
            dims[1] = "data"
        return dims
    if name in ("lm_head", "fc_w"):
        if div(1, m):
            dims[1] = "model"
        if d_axis and div(0, d_axis):
            dims[0] = "data"
        return dims
    if name in _EXPERT:
        if div(0, m):
            dims[0] = "model"                 # expert parallelism
        if d_axis and div(1, d_axis):
            dims[1] = "data"                  # fsdp on the d_model dim
        return dims
    if name in _COL and len(shape) == 2:
        if div(1, m):
            dims[1] = "model"
        else:
            plan.replicated.append(name)
        if d_axis and div(0, d_axis):
            dims[0] = "data"
        return dims
    if name in _ROW and len(shape) == 2:
        if div(0, m):
            dims[0] = "model"
        else:
            plan.replicated.append(name)
        if d_axis and div(1, d_axis):
            dims[1] = "data"
        return dims
    # convs, norms, biases and everything else: replicated
    return dims


# --------------------------------------------------------------------------
# batch and cache specs
# --------------------------------------------------------------------------
def batch_spec(axes: Axes, *, fed_axes: Tuple[str, ...] = (),
               batch_axes: Tuple[str, ...] = ("data",)) -> Tuple[str, ...]:
    """The batch dim's axes: those of ``batch_axes`` wider than 1 (the
    whole spec of a (G?, steps?, B, ...) batch is built in ``specs.py``)."""
    return tuple(a for a in batch_axes if axes.get(a, 1) > 1)


def cache_plan(cfg: ModelConfig, axes: Axes, cache_shapes: PyTree,
               batch: int, seq_shard: bool = False) -> PyTree:
    """Specs of the KV / latent / SSM / RWKV caches. The batch dim over
    "data" (and "pod") where it divides; at batch 1 (long_500k) the
    SEQUENCE dim over "data" instead; kv-head or latent dims over "model"
    where they divide.

    seq_shard=True: the cache's sequence dim over "model" instead of the
    kv heads or head dim (decode attention then sums softmax statistics
    over the sharded sequence rather than gathering fractional heads)."""
    m = axes.get("model", 1)
    d_axis = axes.get("data", 1)
    p_axis = axes.get("pod", 1)
    bdims: Tuple[str, ...] = ()
    if p_axis > 1 and batch % (d_axis * p_axis) == 0:
        bdims = ("pod", "data")
    elif batch % d_axis == 0 and d_axis > 1:
        bdims = ("data",)
    bentry = (bdims if len(bdims) > 1 else bdims[0]) if bdims else None

    def seq_dims(s, shape, off):
        if seq_shard and shape[off + 1] % m == 0:
            s[off + 1] = "model"
            if not bdims and shape[off + 1] % (m * d_axis) == 0:
                s[off + 1] = ("data", "model")
            return True
        if not bdims and shape[off + 1] % d_axis == 0:
            s[off + 1] = "data"
        return False

    def spec(path, leaf) -> Spec:
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        if name == "pos":
            return ()
        if name in ("k", "v"):                 # (stack?, B, S, KV, HD)
            off = len(shape) - 4
            s: List[Any] = [None] * len(shape)
            s[off] = bentry
            if not seq_dims(s, shape, off):
                if shape[off + 2] % m == 0:
                    s[off + 2] = "model"
                elif shape[off + 3] % m == 0:
                    s[off + 3] = "model"
            return tuple(s)
        if name in ("c_kv", "k_rope"):         # (stack?, B, S, R)
            off = len(shape) - 3
            s = [None] * len(shape)
            s[off] = bentry
            if not seq_dims(s, shape, off):
                if name == "c_kv" and shape[off + 2] % m == 0:
                    s[off + 2] = "model"
            return tuple(s)
        if name in ("ssm", "state", "x_prev", "ffn_x_prev", "conv"):
            # ssm (stack?, B, DI, ST), state (stack?, B, H, HD, HD),
            # x_prev (stack?, B, D): the dim after the batch over "model";
            # conv (stack?, B, CW-1, DI): its last dim
            off = len(shape) - {"ssm": 3, "conv": 3, "state": 4}.get(name, 2)
            s = [None] * len(shape)
            s[off] = bentry
            over = off + 2 if name == "conv" else off + 1
            if shape[over] % m == 0:
                s[over] = "model"
            return tuple(s)
        if name == "enc_out":                  # (B, ENC, D)
            return (bentry, None, None)
        return ()

    return map_with_path(spec, cache_shapes)
