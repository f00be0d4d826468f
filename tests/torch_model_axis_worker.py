"""One rank of ``tests/test_torch_model_axis.py``: a process of a gloo world
on the CPU. It reads a job (``torch.save``d by the test): a list of cases,
each a step kind on a mesh shape with its config, full weights and
inputs (prefill and decode in f32 unless the case names a dtype), or
one layer with its weights and input, or one row-parallel product; a
case may name an FSDP threshold (the planner's, for that case) and a
decode case ``seq_shard`` (the rings' sequence over "model"); a layer case
``seq`` (its input's positions split over "model", the layer run on this
rank's chunk); a "collectives" case runs ``core/collectives.py``'s
all-to-all and reduce-scatter on CPU tensors, a "mailbox" case its
same-card route over mailboxes mapped from files. It places the weights
on the step's plan (``sharding.distribute_tree``), runs the port's step
(or the layer) on the mesh, gathers what the step returns
(``sharding.gather_tree``) and saves it, with the query heads each
attention call of this rank ran on and how many times the case called
each of the collectives that sequence parallelism adds or removes
(``reduce_scatter_cat``, ``all_to_all``, ``model_axis.reduce``) and the
MoE's pairs kept of those routed a route, for the test to compare, and
the collectives (``core/collectives.py`` ``calls``: count and bytes by
kind) that the step's first call made on this rank, which the tests hold
to the dry run's count. A 3-d mesh shape is ("pod", "data", "model").
It imports torch and ``repro_torch`` only.

    python tests/torch_model_axis_worker.py RANK WORLD INIT_FILE JOB OUT
"""
import datetime
import sys

import torch
import torch.distributed as dist


def _mesh(shape):
    from repro_torch.launch.mesh import (MULTI_POD_AXES, PRODUCTION_AXES,
                                         mesh_over_world)
    return mesh_over_world(tuple(shape), MULTI_POD_AXES if len(shape) == 3
                           else PRODUCTION_AXES, "cpu")


# the collectives of the case's first step call: kind -> (count, bytes)
TALLY = {}


def _tallied(step, *args):
    """``step(*args)``, with the collectives it calls kept in ``TALLY``
    if it is the case's first call."""
    from repro_torch.core import collectives as C
    C.calls.clear()
    out = step(*args)
    if not TALLY:
        TALLY.update({k: tuple(v) for k, v in C.calls.items()})
    return out


def _prefill(case, mesh, axes):
    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.launch.specs import step_plan
    from repro_torch.launch.steps import make_prefill_step
    step, lm = make_prefill_step(case["cfg"], mesh=mesh,
                                 dtype=case.get("dtype", torch.float32))
    params = distribute_tree(case["params"], step_plan(
        case["cfg"], axes, case["plan"], lm=lm), mesh)
    return _tallied(step, params, case["batch"])


def _decode(case, mesh, axes):
    from repro_torch.launch.sharding import distribute_tree, gather_tree
    from repro_torch.launch.specs import cache_on_mesh, step_plan
    from repro_torch.launch.steps import make_decode_step
    cfg, tokens = case["cfg"], case["tokens"]
    dtype = case.get("dtype", torch.float32)
    seq_shard = case.get("seq_shard", False)
    step, lm = make_decode_step(cfg, dtype=dtype, mesh=mesh,
                                cache_seq_shard=seq_shard)
    params = distribute_tree(case["params"], step_plan(
        cfg, axes, "decode", lm=lm), mesh)
    cache = cache_on_mesh(lm, mesh, tokens.shape[0], case["slots"],
                          dtype=dtype, seq_shard=seq_shard)
    picked = []
    for i in range(tokens.shape[1]):        # teacher-forced
        nxt, cache = _tallied(step, params, cache, tokens[:, i:i + 1])
        picked.append(nxt)
    return torch.cat(picked, 1), gather_tree(cache)


def _train(case, mesh, axes):
    from repro_torch.core.fedavg import broadcast_to_clients
    from repro_torch.launch.sharding import distribute_tree, gather_tree
    from repro_torch.launch.specs import step_plan
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.optim.optimizers import tree_map
    cfg, tcfg, g = case["cfg"], case["tcfg"], case["g"]
    step, lm = make_train_step(cfg, tcfg, mesh=mesh)
    plan = step_plan(cfg, axes, "train", tcfg, lm, g)
    stacked = broadcast_to_clients(case["params"], g)
    params = distribute_tree(stacked, plan, mesh)
    # a momentum's state on the params' placements
    state = (distribute_tree(tree_map(torch.zeros_like, stacked), plan,
                             mesh) if tcfg.momentum else ())
    new, new_s, metrics = _tallied(step, params, state, case["batch"],
                                   case["first"])
    return ([x[0] for x in tree_leaves(gather_tree((new, new_s)))],
            {k: float(v) for k, v in metrics.items()})


def _layer(case, mesh, axes):
    """One layer's forward on the model axis: its weights on the plan
    (under the block's key, "mixer" or "ffn", whose path the planner
    reads), their local shards run inside ``model_axis.over``."""
    from repro_torch.core.collectives import Ranks
    from repro_torch.launch import sharding as sh
    from repro_torch.models import layers as L
    from repro_torch.models import model_axis as MA
    from repro_torch.core.collectives import all_gather_cat
    cfg, layer = case["cfg"], case["layer"]
    slot = "ffn" if layer in ("moe", "rwkv_ffn") else "mixer"
    tree = {slot: case["params"]}
    plan = sh.plan_params(cfg, axes, tree, head_aware=case["head_aware"])
    p = sh.local_tree(sh.distribute_tree(tree, plan, mesh))[slot]
    x = case["x"]
    ranks = Ranks.of(mesh.get_group("model"))
    seq = case.get("seq", False)
    if seq:                             # this rank's chunk of the positions
        per = x.shape[1] // ranks.size
        x = x[:, ranks.rank * per:(ranks.rank + 1) * per]
    with MA.over(ranks, seq=seq):
        if layer == "moe":
            y, aux = L.moe_apply(p, x, cfg=cfg)
        elif layer == "rwkv_ffn":
            y, aux = L.rwkv_ffn_apply(p, x, cfg=cfg)[0], None
        else:
            y, aux = getattr(L, f"{layer}_apply")(p, x, cfg=cfg,
                                                  mode="full")[0], None
    if seq:
        y = all_gather_cat(y.contiguous(), ranks, 1)
    return y if aux is None else (y, aux)


def _row(case, mesh, axes):
    """``model_axis.row_product`` of this rank's chunk of ``a``'s columns
    and ``w``'s rows, then its backward under this rank's upstream
    gradient ``g[rank]`` -> (y, the gradients of ``a`` and ``w``
    gathered over the ranks)."""
    from repro_torch.core.collectives import Ranks, all_gather_cat
    from repro_torch.models import model_axis as MA
    ranks = Ranks.of(mesh.get_group("model"))
    n = case["a"].shape[-1] // ranks.size
    lo = ranks.rank * n
    a = case["a"][:, lo:lo + n].clone().requires_grad_()
    w = case["w"][lo:lo + n].clone().requires_grad_()
    with MA.over(ranks):
        y = MA.row_product(a, w, shared=case["shared"])
    y.backward(case["g"][ranks.rank])
    return (y.detach(), all_gather_cat(a.grad, ranks, 1),
            all_gather_cat(w.grad, ranks, 0))


def _collectives(case, mesh, axes):
    """``collectives.all_to_all`` and ``reduce_scatter_cat`` over the
    model axis of each rank's ``case["x"][rank]`` along each of its dims,
    with every rank's tensor gathered beside them (what they take from),
    the mailboxes opened and the bytes moved on the same-card route."""
    from repro_torch.core import collectives as C
    ranks = C.Ranks.of(mesh.get_group("model"))
    x = case["x"][ranks.rank]
    out = {"every": C.all_gather_tree(x, ranks)}
    for dim in range(x.ndim):
        out[("all_to_all", dim)] = C.all_to_all(x, ranks, dim)
        out[("reduce_scatter", dim)] = C.reduce_scatter_cat(x, ranks, dim)
    out["route"] = C.same_card(x, ranks)
    out["mailboxes"] = len(C._MAILBOXES)
    out["moved"] = dict(C.moved)
    return out


def _mailbox(case, mesh, axes):
    """The same-card route's piece logic on CPU tensors: each rank's
    mailbox a file under ``case["dir"]`` that every rank maps
    (``torch.from_file(..., shared=True)``) in place of a CUDA IPC buffer,
    halves of ``case["piece"]`` bytes (so a call takes many turns), the
    stream's synchronize a no-op; every collective of ``case["x"][rank]``
    on that route and on the host route (gloo) -> {collective: (the
    mailboxes', the host's)}, each on every dim that splits, and the sums
    in rank order of the gathered tensors."""
    import os
    from repro_torch.core import collectives as C
    ranks = C.Ranks.of(mesh.get_group("model"))
    piece = case["piece"]

    def box(r):
        return torch.from_file(os.path.join(case["dir"], f"box{r}"),
                               shared=True, size=2 * piece,
                               dtype=torch.uint8).view(2, piece)
    mine = box(ranks.rank)
    dist.barrier(group=ranks.group)          # every rank's file made
    mailbox = C.Mailbox(mine, [box(r) for r in range(ranks.size)])
    x = case["x"][ranks.rank]

    class _Stream:
        def synchronize(self):
            pass

    def run():
        out = {"gather": C.all_gather_cat(x, ranks, 0),
               "sum": C.all_reduce_tensor(x, ranks),
               "max": C.all_reduce_tensor(x, ranks, "max")}
        for dim in range(x.ndim):
            out[("all_to_all", dim)] = C.all_to_all(x, ranks, dim)
            out[("reduce_scatter", dim)] = C.reduce_scatter_cat(x, ranks,
                                                                dim)
        tree = {"t": x.clone()}
        out["sum_tree"] = C.all_reduce_sum_tree(tree, ranks)["t"]
        return out
    host = run()
    saved = C.same_card, C.CARD_PIECE, torch.cuda.current_stream
    C.same_card = lambda t, r: mailbox
    C.CARD_PIECE = piece
    torch.cuda.current_stream = lambda *a: _Stream()
    try:
        card = run()
    finally:
        C.same_card, C.CARD_PIECE, torch.cuda.current_stream = saved
    return {k: (card[k], host[k]) for k in card}


RUN = {"prefill": _prefill, "decode": _decode, "train": _train,
       "layer": _layer, "row": _row, "collectives": _collectives,
       "mailbox": _mailbox}


def run(job):
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.models import layers as L
    from repro_torch.models import model_axis as MA
    heads, calls, kept = [], {}, []
    for name in ("_prefill_core", "sdpa_decode", "sdpa_decode_stats"):
        def seen(q, *args, _fn=getattr(L, name), **kwargs):
            heads.append(q.shape[2])
            return _fn(q, *args, **kwargs)
        setattr(L, name, seen)
    # the collectives each case calls (model_axis binds its own names)
    for mod, name in ((MA, "reduce_scatter_cat"), (MA, "all_to_all"),
                      (MA, "reduce")):
        def counted(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        setattr(mod, name, counted)

    def route(*args, _fn=L.moe_route, **kwargs):
        r = _fn(*args, **kwargs)
        kept.append((int(r.keep.sum()), r.keep.numel()))
        return r
    L.moe_route = route
    out = {}
    for key, case in job.items():
        mesh = _mesh(case["mesh"])
        heads.clear()
        calls.clear()
        kept.clear()
        # a case's "fsdp_threshold" stands in for the planner's (the
        # reduced archs lie far below the full ones' FSDP threshold)
        threshold = sharding.FSDP_THRESHOLD
        sharding.FSDP_THRESHOLD = case.get("fsdp_threshold", threshold)
        L.head_dim_gather["bytes"] = 0
        TALLY.clear()
        try:
            got = RUN[case["kind"]](case, mesh, mesh_axis_sizes(mesh))
        finally:
            sharding.FSDP_THRESHOLD = threshold
        out[key] = (got, sorted(set(heads)))
        out[key + ("gathered",)] = L.head_dim_gather["bytes"]
        out[key + ("calls",)] = dict(calls)
        # the MoE's (token, choice) pairs kept and routed, a route a call
        out[key + ("kept",)] = list(kept)
        out[key + ("collectives",)] = dict(TALLY)
    return out


def main(rank, world, init_file, job_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        torch.save(run(torch.load(job_path, weights_only=False)), out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
