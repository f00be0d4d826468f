"""Step functions of the LM path: the port of ``repro.launch.steps``.

train_step   — ONE federated round per call (the paper's Algorithm 1 on
               an LM): G cohorts from the batch's leading axis, each
               running L local SGD steps (f32 gradients accumulated over
               microbatches), FedAvg as the mean over G, then the split-FL
               path: hidden states at the split layer, PCA + K-means
               selection per cohort, meta-training of the upper part on
               the selected sequences, compose. The reference ``vmap``s
               the cohorts over a mesh. The port runs them one after
               another, and FedAvg is a running sum (``fedavg.RunningSum``):
               each cohort's trained tree is added as soon as the cohort
               is done and then dropped, so the memory does not grow with
               G. Given a mesh whose fed axes (``specs.fed_layout``) hold
               w ranks, each rank runs its G/w cohorts; the sums are
               all-reduced, the per-cohort losses and selected rows
               all-gathered in cohort order, and every rank runs the same
               meta steps, so every rank leaves with the same weights. The
               meta steps take the head and its log-softmax a microbatch
               of selected rows at a time, so their memory does not grow
               with G either. A mesh whose "model" axis is above 1 runs
               tensor parallel inside each cohort (every family:
               ``models/model_axis.py``; the experts expert parallel):
               the weights are DTensors on the train plan
               (``launch/specs.py`` ``step_plan``), each rank trains its
               shard of them, the selection runs on every model rank over
               the same replicated activations, the MoE's ``aux`` enters
               the loss as on one rank (every rank computes the whole
               route), and the round returns DTensors on the same
               placements. With ``seq_shard_activations`` the hidden
               states between blocks hold each model rank's chunk of the
               positions (Megatron's sequence parallelism, on the
               head-aware train plan): norms and residual adds run on
               the chunk, a block's column-parallel work on the
               positions gathered, its row-parallel output
               reduce-scattered on them, the MoE's tokens routed a rank
               at a time and sent to their experts' ranks by an
               all-to-all (``models/model_axis.py``, ``layers.py``
               ``_moe_own_tokens``). An arch above ``FSDP_THRESHOLD`` on one pod
               runs G = 1 with "data" over its weights' second dim and its
               cohort's rows (``models/fsdp.py``): each data rank trains
               its rows, every gradient is the mean over the data ranks
               (reduce-scattered, or all-reduced for the leaves whole on
               every data rank), the probe's hidden states are gathered
               over "data" and every rank runs the same selection and
               meta steps.
prefill_step — causal forward over the prompt (after the encoder's pass
               or the vision prefix, where the batch has them),
               last-position logits only; the KV cache is not filled
               (as in the reference).
decode_step  — one token against the (ring-buffer) cache, greedy argmax;
               the cache is updated in place and returned.

Given a mesh, prefill and decode take their weights as DTensors on either
inference plan (``step_plan``) and the cache on ``cache_plan``'s
placements (``specs.cache_on_mesh``): the kv heads (or their head dim),
MLA's latent, Mamba's channels and RWKV's heads over "model", a ring's
sequence over "data" at batch 1 or, with ``cache_seq_shard``, over
"model". Each rank runs its heads' kernels (MLA's rebuilt from the
gathered latent), its experts, its channels and its shard of the FFN and
of the vocabulary, its share of the batch's rows, its slots of a split
ring (the decode kernel's softmax statistics merged over the ranks),
FSDP's weights gathered over "data" a block at a time, and every rank
returns the same logits or tokens. The rows split as the plans split
them: over ("pod", "data") where the batch divides both, else over
"data" (each pod then a replica of the other), else not at all. RWKV or
MLA heads that do not divide the model axis run on every head a rank's
columns touch, whole (``model_axis.frac_heads``).

The groups a step can use are made when the step is made, on every rank
(``Grid``: one a set of the mesh's axes above 1; making a group is a
collective, so none is made inside a call). The dry run
(``launch/dryrun.py``) makes a step with ``ranks=`` instead of a mesh: a
``StepRanks`` over ``rank_grid``, whose groups only name one rank's
place, and calls it with that rank's shards as ``sharding.Placed``
leaves, whose specs the step reads where it reads a DTensor's placements
(FSDP's dims, the rings' split); every collective is then charged, not
sent.

Inference computes in ``dtype`` (bf16 by default, as the reference) and
runs without autograd; training computes in ``TrainConfig.dtype`` on f32
master weights, whose gradients come back f32 through the casts.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import fedavg as fa
from repro_torch.core import selection as sel
from repro_torch.core.collectives import (Ranks, all_gather_cat,
                                          all_gather_tree,
                                          all_reduce_tensor)
from repro_torch.launch import sharding as sh
from repro_torch.models import fsdp as FS
from repro_torch.models import layers as L
from repro_torch.models import model_axis as MA
from repro_torch.models.transformer import LM, split_stages, unpack_batch
from repro_torch.optim.optimizers import (sgd, tree_map,
                                          value_and_grad)

PyTree = Any
# each cohort's K-means first centre: a (G,) index tensor or sequence, or a
# torch.Generator (a uniform row of the cohort's probe batch each)
FirstCentres = Union[torch.Tensor, Sequence[int], torch.Generator]


def _dtype(tcfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if tcfg.dtype == "bfloat16" else torch.float32


def _first_centre(first: FirstCentres, g: int, rows: int) -> int:
    if isinstance(first, torch.Generator):
        return int(torch.randint(rows, (1,), generator=first))
    if isinstance(first, torch.Tensor) and first.is_meta:
        return 0            # the dry run's count: no value to read
    return int(first[g])


def _head_nll(hn: torch.Tensor, tokens: torch.Tensor,
              w_head: torch.Tensor, vocab: int) -> torch.Tensor:
    """Next-token NLL (rows, T-1) of normed hidden states through the
    head, the log-softmax in f32 (over the ranks' vocabulary chunks on a
    model axis)."""
    return MA.next_token_nll(hn, w_head, tokens, vocab)


def tree_stack(trees: Sequence[PyTree]) -> PyTree:
    """One tree whose leaves stack the trees' leaves on a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# --------------------------------------------------------------------------
# train: one federated round per call
# --------------------------------------------------------------------------
class Grid(NamedTuple):
    """Where a step's rank sits: the mesh's axis sizes (in the mesh's
    order), this rank's coordinate on each, the group of every set of
    the axes above 1 (keyed by their names in the mesh's order; a group's
    rank order is the mesh's, its major axis first), and the
    ``DeviceMesh`` (None: a rank the dry run counts, ``rank_grid``)."""
    axes: Dict[str, int]
    coord: Dict[str, int]
    groups: Dict[Tuple[str, ...], Ranks]
    mesh: Any


def _subsets(axes: Dict[str, int]):
    above = [a for a, n in axes.items() if n > 1]
    return [sub for k in range(1, len(above) + 1)
            for sub in itertools.combinations(above, k)], len(above)


def mesh_grid(mesh) -> Grid:
    """``mesh``'s ``Grid``: an axis's group is its mesh dim's, all of the
    axes above 1 the world's (the mesh spans it in rank order), another
    set the flattened submesh's; every rank makes them in one order."""
    names = tuple(mesh.mesh_dim_names)
    axes = dict(zip(names, mesh.shape))
    groups = {}
    subsets, n_above = _subsets(axes)
    for sub in subsets:
        if len(sub) == 1:
            group = mesh.get_group(sub[0])
        elif len(sub) == n_above:
            group = None
        else:
            group = mesh[sub]._flatten().get_group()
        groups[sub] = Ranks.of(group)
    return Grid(axes, dict(zip(names, mesh.get_coordinate())), groups, mesh)


def rank_grid(axes: Dict[str, int],
              coord: Optional[Dict[str, int]] = None) -> Grid:
    """The ``Grid`` of the rank at ``coord`` (0 on every axis by default)
    on a mesh of ``axes`` sizes, with no process group: each group a
    ``Ranks(None, index, size)`` that names the rank's place in it, so
    its collectives are charged, not sent (the dry run)."""
    coord = {a: (coord or {}).get(a, 0) for a in axes}
    groups = {}
    for sub in _subsets(axes)[0]:
        index, n = 0, 1
        for a in sub:                       # major axis first
            index, n = index * axes[a] + coord[a], n * axes[a]
        groups[sub] = Ranks(None, index, n)
    return Grid(dict(axes), coord, groups, None)


def _grid(where) -> Grid:
    return where if isinstance(where, Grid) else mesh_grid(where)


def _axes_group(grid: Grid, names: Sequence[str]) -> Optional[Ranks]:
    """The group of the mesh axes ``names`` above 1 (None where none
    is)."""
    key = tuple(a for a, n in grid.axes.items() if a in names and n > 1)
    return grid.groups[key] if key else None


class StepRanks(NamedTuple):
    """The groups a step runs over: ``fed`` the ranks that split the
    cohorts (the train step; None: one), ``model`` the model axis (None at
    1), ``data`` the "data" axis that FSDP gathers the weights over (and,
    in training, splits a cohort's rows over; None at 1 or where it
    carries cohorts), and the ``Grid`` with the other groups (an
    inference batch's rows: ``_row_ranks``; a split ring's)."""
    fed: Optional[Ranks]
    model: Optional[Ranks]
    data: Optional[Ranks]
    grid: Grid


def fed_ranks(cfg: ModelConfig, mesh,
              tcfg: Optional[TrainConfig] = None) -> StepRanks:
    """The ranks of the train step on ``mesh`` (a ``DeviceMesh`` or a
    ``Grid``): its fed axes (``specs.fed_layout``) carry the cohorts, one
    group over all of them (the flattened ("pod", "data") on two pods),
    its "model" axis runs each cohort tensor parallel, and where
    ``fed_layout`` leaves "data" to shard the weights (FSDP: the archs
    above ``FSDP_THRESHOLD``, whose cohorts go over "pod") its ranks
    split each cohort's rows and gather the weights a block at a time
    (``models/fsdp.py``). ``tcfg`` does not change the ranks
    (``seq_shard_activations`` splits the positions over the same model
    axis)."""
    from repro_torch.launch.specs import fed_layout
    grid = _grid(mesh)
    _, fed_axes = fed_layout(cfg, grid.axes)
    data = _axes_group(grid, ("data",)) if "data" not in fed_axes else None
    return StepRanks(_axes_group(grid, fed_axes),
                     _axes_group(grid, ("model",)), data, grid)


def serve_ranks(cfg: ModelConfig, mesh) -> StepRanks:
    """The ranks of prefill and decode on ``mesh`` (a ``DeviceMesh`` or a
    ``Grid``): the model axis, and "data" (above ``FSDP_THRESHOLD`` the
    weights' second dim: FSDP); the batch's rows take their group at call
    time (``_row_ranks``)."""
    grid = _grid(mesh)
    return StepRanks(None, _axes_group(grid, ("model",)),
                     _axes_group(grid, ("data",)), grid)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    observe=None, ranks: Optional[StepRanks] = None):
    """-> (train_step, lm). ``train_step(client_params, opt_state, batch,
    first) -> (new_client_params, opt_state, metrics)``:

    * ``client_params``: the full model's tree with a leading cohort axis
      G on every leaf (f32 master weights); ``opt_state`` the optimizer's
      state stacked the same way (``()`` for plain SGD);
    * ``batch``: {"tokens": (G, L, n_micro, mb, T) int} and, as the model
      takes them, the reference's extras beside them, (G, L, n_micro, mb,
      ...): "prefix_embeds" (..., P, d) for a VLM, "enc_frames" (..., Se,
      d) for an encoder-decoder (any other key raises ``ValueError``);
    * ``first``: with ``split_fl``, each cohort's K-means first centre (see
      ``FirstCentres``; the reference draws it from its key);
    * ``metrics``: {"loss", and with ``split_fl`` "meta_loss",
      "selected"}, 0-d tensors.

    Every cohort leaves the round with W_G(t), the composed model (the
    returned leaves are views of one tree).

    With a ``mesh`` (a ``DeviceMesh`` over the world, ``launch.mesh``),
    every rank calls the step with the same arguments; the w ranks of the
    fed axes (``fed_ranks``) split the G cohorts, contiguous and in order
    (w must divide G), and every rank returns the same round.

    ``observe``, where given, is called as ``observe(event, value)`` so a
    caller can read the round's inner values without copying the step:
    ("cohort", the cohort's trained tree) as each of this rank's cohorts
    is done, before the running sum takes it; ("selection", the cohort's
    ``selection.Selection``) with ``split_fl``; ("cohorts_done", None)
    once every cohort is in the sum (the sums all-reduced), before the
    mean; ("average", the FedAvg mean W_G) before the meta steps.

    ``ranks``, where no ``mesh`` is given, are the step's groups: the dry
    run (``launch/dryrun.py``) counts one rank's share of the step on
    meta tensors through ``fed_ranks(cfg, rank_grid(axes, coord))``,
    whose collectives are charged, not sent; its ``client_params`` (and
    ``opt_state``) are then that rank's shards as ``sharding.Placed``
    leaves, and it gets that rank's local tensors back.

    On a mesh whose "model" axis is above 1, or whose "data" axis shards
    the weights (FSDP), ``client_params`` (and a momentum ``opt_state``)
    are DTensors on the train plan's placements (``specs.step_plan(cfg,
    axes, "train", tcfg, lm, g)``, placed by ``sharding.distribute_tree``;
    on a mesh of fed axes only they may be, or every rank may take the
    whole tree): each rank holds its fed share of the cohorts and its
    shard of every leaf, trains them, and gets DTensors back on the same
    placements (``sharding.gather_tree`` gives the full tree); ``observe``
    then sees the local shards."""
    sr = fed_ranks(cfg, mesh, tcfg) if mesh is not None else ranks
    ranks, model, data, grid = sr if sr is not None else (None,) * 4
    mesh = grid.mesh if grid is not None else None
    observe = observe or (lambda event, value: None)
    opt = sgd(tcfg.lr, momentum=tcfg.momentum,
              weight_decay=tcfg.weight_decay)
    dt = _dtype(tcfg)
    # split boundary (stage-aligned) for the split-FL metadata path
    lm_split = LM(cfg, remat=tcfg.remat)
    lm_split.stages, boundary_stage = split_stages(cfg, cfg.split_layer)
    n_stages = len(lm_split.stages)

    def local_loss(p, batch):
        return lm_split.loss(p, batch, dtype=dt)

    def one_cohort(params, opt_state, tokens, extras, rows, dims):
        """L local steps (each over microbatches with f32 gradient
        accumulation; each microbatch with its extras) -> (params,
        opt_state, mean loss). With FSDP, this data rank's ``rows`` of
        each microbatch (None: all) and the parameters' data-split
        ``dims``: every gradient is then the mean over the data ranks
        (the data-split leaves' through their gather, the others averaged
        here), and so is the loss."""
        step_losses = []
        for li, tok_mb in enumerate(tokens):   # (n_micro, mb, T) a step
            g_sum, losses = None, []
            for mi, t in enumerate(tok_mb):
                batch = dict(tokens=t,
                             **{k: v[li, mi] for k, v in extras.items()})
                if rows is not None:
                    batch = {k: v[rows] for k, v in batch.items()}
                loss, g = value_and_grad(local_loss, params, batch)
                g = tree_map(lambda x: x.to(torch.float32), g)
                g_sum = g if g_sum is None else tree_map(torch.add, g_sum, g)
                losses.append(loss)
            n_micro = tok_mb.shape[0]
            # (g / 1 is g: no copy of the gradients for one microbatch)
            g_mean = (g_sum if n_micro == 1
                      else tree_map(lambda x: x / n_micro, g_sum))
            if data is not None:
                g_mean = FS.mean_grads(g_mean, dims, data)
            params, opt_state = opt.apply(g_mean, opt_state, params)
            step_losses.append(torch.stack(losses).mean())
        loss = torch.stack(step_losses).mean()
        if data is not None:
            loss = all_reduce_tensor(loss.detach(), data) / data.size
        return params, opt_state, loss

    def select_cohort(params, probe, probe_ex, first_row, rows):
        """§3.1 on one cohort: the hidden states of its probe batch (with
        its extras) at the split (computed from the cohort's new weights;
        under FSDP each data rank's ``rows`` of it, gathered over "data"),
        mean-pooled over the T (+ P) positions, PCA + K-means over all rows
        -> the selected (acts, tokens, extras, valid)."""
        with torch.no_grad():
            acts, _, _ = lm_split.apply(
                params, probe if rows is None else probe[rows],
                mode="full", stage_range=(0, boundary_stage), dtype=dt,
                **{k: v if rows is None else v[rows]
                   for k, v in probe_ex.items()})
            if rows is not None:
                acts = all_gather_cat(acts.contiguous(), data, 0)
            s_ = sel.select_metadata(                      # (mb, T(+P), d)
                acts.mean(1), None, first_row, per_class=False,
                clusters_per_class=tcfg.meta_clusters,
                pca_components=min(tcfg.pca_components, probe.shape[0] - 1),
                kmeans_iters=8)
            observe("selection", s_)
            idx = s_.indices
            return (acts[idx], probe[idx],
                    {k: v[idx] for k, v in probe_ex.items()}, s_.valid)

    plans = {}

    def placed_args(client_params, opt_state, g_ax):
        """The round's DTensor arguments checked against the train plan
        -> (their placements, their data-split dims, local params, local
        opt_state); the dry run's ``Placed`` shards unchecked (no
        placements)."""
        if mesh is None:
            return (None, FS.data_dims(client_params, grid.axes),
                    sh.local_tree(client_params), sh.local_tree(opt_state))
        if g_ax not in plans:
            from repro_torch.launch.mesh import mesh_axis_sizes
            from repro_torch.launch.specs import step_plan
            plans[g_ax] = step_plan(cfg, mesh_axis_sizes(mesh), "train",
                                    tcfg, lm_split, g_ax).placements(mesh)
        got = sh.placements_of(client_params)
        if got != plans[g_ax]:
            raise ValueError("train_step on a model or data-sharded axis "
                             "takes the cohorts' parameters as DTensors on "
                             "the train plan (sharding.distribute_tree("
                             "tree, specs.step_plan(..., 'train', ...), "
                             "mesh))")
        return (got, FS.data_dims(client_params, grid.axes),
                sh.local_tree(client_params), sh.local_tree(opt_state))

    def data_rows(tokens, extras):
        """This data rank's rows of each microbatch (None: all of them,
        where the data axis does not divide them, as the plan leaves them
        replicated); an MoE needs each rank's tokens in whole groups."""
        mb = tokens.shape[3]
        if data is None or mb % data.size:
            return None
        per = mb // data.size
        n_tok = per * (tokens.shape[-1] + (
            cfg.num_prefix_tokens if "prefix_embeds" in extras else 0))
        if cfg.is_moe and n_tok % 512:
            raise ValueError(
                f"{cfg.name}: {n_tok} tokens a data rank a microbatch are "
                f"no whole groups of 512, so the MoE over rows split over "
                f"'data' would route another function than one rank's")
        return slice(data.rank * per, (data.rank + 1) * per)

    def train_step(client_params, opt_state, batch, first=None):
        with MA.over(model, seq=tcfg.seq_shard_activations):
            return one_round(client_params, opt_state, batch, first)

    def one_round(client_params, opt_state, batch, first):
        tokens, extras = unpack_batch(batch)
        if tcfg.split_fl and first is None:
            raise ValueError("train_step: split_fl needs each cohort's "
                             "K-means first centre (first=...)")
        g_ax = tokens.shape[0]
        mine = ranks.share(g_ax) if ranks is not None else range(g_ax)
        # this rank's shards of the weights, not the whole tree: DTensors
        # (always, on a model or data-sharded axis), or the dry run's rank
        local = sr is not None and (mesh is None or model is not None
                                    or data is not None
                                    or sh.holds_dtensors(client_params))
        placed, at, dims, rows = None, 0, None, None
        if local:
            # this rank's cohorts (from ``at``) and shards, local
            placed, dims, client_params, opt_state = placed_args(
                client_params, opt_state, g_ax)
            at = mine.start
            rows = data_rows(tokens, extras)
        # every cohort's first centre, drawn in cohort order on every rank
        firsts = ([_first_centre(first, g, tokens.shape[3])
                   for g in range(g_ax)] if tcfg.split_fl else None)
        # FedAvg (Eq. 2) as a running sum: each cohort's trained tree is
        # added as soon as the cohort is done, then dropped
        total = fa.RunningSum(
            tree_map(lambda x: x[0], client_params)
            if tcfg.fedavg_compress == "bf16" else None)
        new_s, losses, selected = [], [], []
        for g in mine:
            p = tree_map(lambda x: x[g - at], client_params)
            s = tree_map(lambda x: x[g - at], opt_state) if opt_state else ()
            with FS.over(data, dims, data if rows is not None else None):
                p, s, loss = one_cohort(p, s, tokens[g],
                                        {k: v[g] for k, v in extras.items()},
                                        rows, dims)
            new_s.append(s)
            losses.append(loss)
            if tcfg.split_fl:
                # the probe: each cohort's first microbatch of its first
                # local step (and its extras), read by the cohort's new
                # weights
                probe = tokens[g, 0, 0]                    # (mb, T)
                probe_ex = {k: v[g, 0, 0] for k, v in extras.items()}
                with FS.over(data, dims,
                             data if rows is not None else None):
                    selected.append(select_cohort(p, probe, probe_ex,
                                                  firsts[g], rows))
            observe("cohort", p)
            total.add(p)
            del p
        losses = torch.stack(losses)
        new_s = tree_stack(new_s) if opt_state else ()
        if tcfg.split_fl:
            # each field stacked over this rank's cohorts
            selected = (torch.stack([a for a, _, _, _ in selected]),
                        torch.stack([t for _, t, _, _ in selected]),
                        {k: torch.stack([e[k] for _, _, e, _ in selected])
                         for k in extras},
                        torch.stack([v for _, _, _, v in selected]))
        if ranks is not None:
            # the other ranks' cohorts: sums added, the rest gathered in
            # cohort order ((w, G/w, ...) -> (G, ...)); on a model axis the
            # optimizer's state stays with its cohorts' ranks
            total.all_reduce(ranks)
            losses, gathered_s, selected = tree_map(
                lambda x: x.reshape((g_ax,) + tuple(x.shape[2:])),
                all_gather_tree((losses, () if local else new_s,
                                 selected), ranks))
            if not local:
                new_s = gathered_s

        observe("cohorts_done", None)
        with torch.no_grad():
            avg = total.mean(g_ax)
        del total
        observe("average", avg)
        metrics = {"loss": losses.mean()}

        if tcfg.split_fl:
            # server aggregation: the selected maps of every cohort, in
            # cohort order
            meta_acts, meta_tok, meta_ex, meta_w = tree_map(
                lambda x: x.reshape((-1,) + tuple(x.shape[2:])), selected)
            meta_w = meta_w.to(torch.float32)
            del selected
            # meta-train the upper part from the averaged upper
            upper = {"stages": list(avg["stages"][boundary_stage:]),
                     "final_norm": avg["final_norm"]}
            if "lm_head" in avg:
                upper["lm_head"] = avg["lm_head"]
            # the selected maps hold the prefix's positions too
            n_prefix = (cfg.num_prefix_tokens if "prefix_embeds" in extras
                        else 0)

            def upper_loss(up, a_mb, t_mb, w_mb, ex_mb):
                p_view = {"stages": [None] * boundary_stage
                          + list(up["stages"]),
                          "final_norm": up["final_norm"],
                          "embed": avg["embed"]}
                if "lm_head" in up:
                    p_view["lm_head"] = up["lm_head"]
                if cfg.is_encoder_decoder:
                    # the upper half's cross-attention reads the selected
                    # rows' frames through the averaged encoder, which is
                    # not in ``up``: no gradient reaches it here
                    p_view["enc_stages"] = avg["enc_stages"]
                    p_view["enc_norm"] = avg["enc_norm"]
                h, _, aux = lm_split.apply(
                    p_view, None, mode="full", hidden_in=a_mb,
                    stage_range=(boundary_stage, n_stages),
                    return_hidden=True, dtype=dt,
                    enc_frames=ex_mb.get("enc_frames"))
                h = h[:, n_prefix:]
                hn = L.rms_norm(h, up["final_norm"].to(h.dtype),
                                cfg.norm_eps)
                w_head = (FS.gather_leaf(up["lm_head"], FS.dims("lm_head"))
                          if "lm_head" in up else FS.gather_leaf(
                              avg["embed"], FS.dims("embed")).T
                          ).to(h.dtype)
                # the head and its f32 log-softmax a chunk of
                # ``microbatch`` rows at a time, recomputed in the
                # backward: the step holds one chunk's logits however
                # many rows the G cohorts selected
                mb = tcfg.microbatch
                nll = torch.cat([checkpoint(_head_nll, hn[i:i + mb],
                                            t_mb[i:i + mb], w_head,
                                            cfg.padded_vocab,
                                            use_reentrant=False)
                                 for i in range(0, hn.shape[0], mb)])
                per = nll.mean(-1) + aux
                return (per * w_mb).sum() / torch.clamp(w_mb.sum(), min=1.0)

            meta_losses = []
            for _ in range(tcfg.meta_steps):
                # every data rank the same selected rows: the data-split
                # leaves' gathers average equal gradients, the others'
                # are equal already
                with FS.over(data, dims):
                    loss_m, gm = value_and_grad(upper_loss, upper,
                                                meta_acts, meta_tok, meta_w,
                                                meta_ex)
                with torch.no_grad():
                    upper = tree_map(lambda p_, g_: p_ - tcfg.lr * g_,
                                     upper, gm)
                meta_losses.append(loss_m)
            metrics["meta_loss"] = torch.stack(meta_losses).mean()
            metrics["selected"] = meta_w.sum()
            # composed model = [avg lower ; meta-trained upper]
            avg = dict(avg, final_norm=upper["final_norm"],
                       stages=(list(avg["stages"][:boundary_stage])
                               + list(upper["stages"])))
            if "lm_head" in upper:
                avg["lm_head"] = upper["lm_head"]

        # redistribute: next round every cohort starts from W_G(t)
        n = len(mine) if local else g_ax
        new_client_params = tree_map(
            lambda x: x[None].expand((n,) + tuple(x.shape)), avg)
        if placed is not None:
            new_client_params = sh.wrap_tree(new_client_params, placed, mesh)
            if opt_state:
                new_s = sh.wrap_tree(new_s, placed, mesh)
        return new_client_params, new_s, metrics

    return train_step, lm_split


# --------------------------------------------------------------------------
# inference steps
# --------------------------------------------------------------------------


def _row_ranks(sr: Optional[StepRanks], batch: int) -> Optional[Ranks]:
    """The group an inference batch of ``batch`` rows splits over, as the
    plans split it (``specs.input_specs``, ``sharding.cache_plan``):
    ("pod", "data") where the rows divide over both, else "data" where
    they divide over it (the pods then replicas), else none (None: every
    rank takes every row)."""
    if sr is None:
        return None
    axes = sr.grid.axes
    p, d = axes.get("pod", 1), axes.get("data", 1)
    if p > 1 and batch % (p * d) == 0:
        return _axes_group(sr.grid, ("pod", "data"))
    if d > 1 and batch % d == 0:
        return _axes_group(sr.grid, ("data",))
    return None


def _rows(ranks: Optional[Ranks], batch: int) -> Optional[slice]:
    """This rank's rows of a batch split over ``ranks`` (None: all)."""
    if ranks is None:
        return None
    per = batch // ranks.size
    return slice(ranks.rank * per, (ranks.rank + 1) * per)


def _gather_rows(x: torch.Tensor, ranks: Optional[Ranks]) -> torch.Tensor:
    if ranks is None:
        return x
    return all_gather_tree(x, ranks).reshape((-1,) + tuple(x.shape[1:]))


def _serve_params(params, sr: Optional[StepRanks]):
    """The weights' local tensors and their data-split dims (FSDP,
    ``fsdp.data_dims``; None off a mesh)."""
    if sr is None:
        return params, None
    return sh.local_tree(params), FS.data_dims(params, sr.grid.axes)


def _seq_split(x, dim: int, grid: Grid):
    """The ``layers.SeqSplit`` of a ring leaf ``x`` (a DTensor, or a
    ``Placed`` shard) whose dim ``dim`` its placements or spec split over
    mesh axes above 1 (None: whole): the group of those axes, whichever
    they are."""
    names = tuple(a for a in sh.split_axes(x).get(dim % sh.leaf_ndim(x), ())
                  if grid.axes[a] > 1)
    if not names:
        return None
    ranks = grid.groups[names]
    index = 0
    for a in names:                        # major axis first
        index = index * grid.axes[a] + grid.coord[a]
    if ranks.rank != index:
        raise ValueError(f"rank {ranks.rank} of the group holds ring chunk "
                         f"{index}")
    return L.SeqSplit(ranks, index, ranks.size, names)


def _rings(cache, where):
    """Each block's ring's ``layers.SeqSplit`` (a list a stage of a list a
    unit position; None where the ring is whole or the block holds a
    state), from the cache's DTensor placements or ``Placed`` specs, on
    ``where`` (a ``Grid`` or a ``DeviceMesh``)."""
    grid = _grid(where)

    def one(block):
        mixer = block.get("mixer", {})
        for name, seq_dim in (("k", -3), ("c_kv", -2)):
            if name in mixer:
                return _seq_split(mixer[name], seq_dim, grid)
        return None
    return [[one(b) for b in st] for st in cache["stages"]]


def make_prefill_step(cfg: ModelConfig, force_swa: bool = False,
                      dtype=torch.bfloat16, mesh=None,
                      ranks: Optional[StepRanks] = None):
    """-> (prefill_step(params, batch) -> (B, 1, padded_vocab) logits, lm);
    ``batch`` is a dict with "tokens" (B, S) and, as the model needs them,
    "prefix_embeds" (B, P, d) or "enc_frames" (B, Se, d).

    With a ``mesh`` the weights are DTensors on an inference plan
    (``specs.step_plan(..., "prefill")`` or ``"decode"``), or plain
    replicated tensors; every rank takes the whole batch and returns the
    whole logits, the same bits on every rank. ``ranks`` in place of a
    mesh: the dry run's rank (``serve_ranks(cfg, rank_grid(...))``), its
    weights ``Placed`` shards."""
    lm = LM(cfg, force_swa=force_swa)
    sr = serve_ranks(cfg, mesh) if mesh is not None else ranks
    model = sr.model if sr is not None else None

    @torch.no_grad()
    def prefill_step(params, batch):
        params, dims = _serve_params(params, sr)
        extras = {k: batch[k] for k in ("prefix_embeds", "enc_frames")
                  if k in batch}
        tokens = batch["tokens"]
        over = _row_ranks(sr, tokens.shape[0])
        rows = _rows(over, tokens.shape[0])
        if rows is not None:
            tokens = tokens[rows]
            extras = {k: v[rows] for k, v in extras.items()}
        with MA.over(model), FS.over(sr and sr.data, dims, over):
            h_all, _, _ = lm.apply(params, tokens, mode="full",
                                   return_hidden=True, dtype=dtype, **extras)
            # last-position logits only (vocab projection on one position)
            # as the reference: the norm weight and the head come from the
            # tree as given (f32 master weights give f32 last-position
            # logits)
            h = L.rms_norm(h_all[:, -1:], params["final_norm"],
                           cfg.norm_eps)
            out = MA.head_logits(h, lm.head(params, h), cfg.padded_vocab)
        return _gather_rows(out, over)

    return prefill_step, lm


def make_decode_step(cfg: ModelConfig, force_swa: bool = False,
                     dtype=torch.bfloat16, mesh=None,
                     cache_seq_shard: bool = False,
                     return_logits: bool = False,
                     ranks: Optional[StepRanks] = None):
    """-> (decode_step(params, cache, tokens (B, 1)) -> (next (B, 1) int32,
    cache), lm); with ``return_logits`` the step also returns the new
    position's logits (B, padded_vocab), whose argmax ``next`` is.

    With a ``mesh``, the weights as ``make_prefill_step``'s and the cache
    a DTensor tree on ``cache_plan``'s placements
    (``specs.cache_on_mesh``, with ``cache_seq_shard`` as the reference's
    ``input_specs``): each rank writes and reads its shard in place (its
    kv heads or head-dim columns, its latent chunk, its states, its
    slots of a ring split on the sequence, whose softmax statistics the
    ranks merge: ``layers.merge_decode``), and every rank returns the
    whole batch's tokens. ``ranks`` in place of a mesh: as
    ``make_prefill_step``'s, the cache ``Placed`` shards too (its local
    shards come back)."""
    lm = LM(cfg, force_swa=force_swa)
    sr = serve_ranks(cfg, mesh) if mesh is not None else ranks
    model = sr.model if sr is not None else None

    @torch.no_grad()
    def decode_step(params, cache, tokens):
        params, dims = _serve_params(params, sr)
        placed = rings = None
        if sr is not None:
            if sr.grid.mesh is not None:
                from repro_torch.launch.specs import check_cache_placements
                placed = check_cache_placements(
                    cfg, sr.grid.mesh, cache, tokens.shape[0],
                    seq_shard=cache_seq_shard)
            rings = _rings(cache, sr.grid)
            cache = sh.local_tree(cache)
        over = _row_ranks(sr, tokens.shape[0])
        rows = _rows(over, tokens.shape[0])
        pos = cache["pos"]
        if rows is not None:
            # the positions are replicated, the rest of the cache holds
            # this rank's rows
            tokens = tokens[rows]
            cache = dict(cache, pos=pos[rows])
        with MA.over(model), FS.over(sr and sr.data, dims, over):
            logits, new_cache, _ = lm.apply(params, tokens, mode="decode",
                                            cache=cache, dtype=dtype,
                                            rings=rings)
        logits = logits[:, -1]
        next_tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        if rows is not None:
            next_tok = _gather_rows(next_tok, over)
            if return_logits:
                logits = _gather_rows(logits.contiguous(), over)
            new_cache["pos"] = pos + 1
        if placed is not None:
            new_cache = sh.wrap_tree(new_cache, placed, sr.grid.mesh)
        if return_logits:
            return next_tok, new_cache, logits
        return next_tok, new_cache

    return decode_step, lm
