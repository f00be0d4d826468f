"""One rank of ``tests/test_torch_model_axis.py``: a process of a gloo world
on the CPU. It reads a job (``torch.save``d by the test): a list of cases,
each a step kind on a mesh shape with its config, full weights and
inputs (prefill and decode in f32 unless the case names a dtype), or
one layer with its weights and input, or one row-parallel product; a
case may name an FSDP threshold (the planner's, for that case) and a
decode case ``seq_shard`` (the rings' sequence over "model"). It places the weights
on the step's plan (``sharding.distribute_tree``), runs the port's step
(or the layer) on the mesh, gathers what the step returns
(``sharding.gather_tree``) and saves it, with the query heads each
attention call of this rank ran on, for the test to compare. It imports
torch and ``repro_torch`` only.

    python tests/torch_model_axis_worker.py RANK WORLD INIT_FILE JOB OUT
"""
import datetime
import sys

import torch
import torch.distributed as dist


def _mesh(shape):
    from repro_torch.launch.mesh import PRODUCTION_AXES, mesh_over_world
    return mesh_over_world(tuple(shape), PRODUCTION_AXES, "cpu")


def _prefill(case, mesh, axes):
    from repro_torch.launch.sharding import distribute_tree
    from repro_torch.launch.specs import step_plan
    from repro_torch.launch.steps import make_prefill_step
    step, lm = make_prefill_step(case["cfg"], mesh=mesh,
                                 dtype=case.get("dtype", torch.float32))
    params = distribute_tree(case["params"], step_plan(
        case["cfg"], axes, case["plan"], lm=lm), mesh)
    return step(params, case["batch"])


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
        nxt, cache = step(params, cache, tokens[:, i:i + 1])
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
    new, new_s, metrics = step(params, state, case["batch"], case["first"])
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
    cfg, layer = case["cfg"], case["layer"]
    slot = "ffn" if layer in ("moe", "rwkv_ffn") else "mixer"
    tree = {slot: case["params"]}
    plan = sh.plan_params(cfg, axes, tree, head_aware=case["head_aware"])
    p = sh.local_tree(sh.distribute_tree(tree, plan, mesh))[slot]
    x = case["x"]
    with MA.over(Ranks.of(mesh.get_group("model"))):
        if layer == "moe":
            return L.moe_apply(p, x, cfg=cfg)
        if layer == "rwkv_ffn":
            return L.rwkv_ffn_apply(p, x, cfg=cfg)[0]
        return getattr(L, f"{layer}_apply")(p, x, cfg=cfg, mode="full")[0]


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


RUN = {"prefill": _prefill, "decode": _decode, "train": _train,
       "layer": _layer, "row": _row}


def run(job):
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.models import layers as L
    heads = []
    for name in ("_prefill_core", "sdpa_decode", "sdpa_decode_stats"):
        def seen(q, *args, _fn=getattr(L, name), **kwargs):
            heads.append(q.shape[2])
            return _fn(q, *args, **kwargs)
        setattr(L, name, seen)
    out = {}
    for key, case in job.items():
        mesh = _mesh(case["mesh"])
        heads.clear()
        # a case's "fsdp_threshold" stands in for the planner's (the
        # reduced archs lie far below the full ones' FSDP threshold)
        threshold = sharding.FSDP_THRESHOLD
        sharding.FSDP_THRESHOLD = case.get("fsdp_threshold", threshold)
        L.head_dim_gather["bytes"] = 0
        try:
            got = RUN[case["kind"]](case, mesh, mesh_axis_sizes(mesh))
        finally:
            sharding.FSDP_THRESHOLD = threshold
        out[key] = (got, sorted(set(heads)))
        out[key + ("gathered",)] = L.head_dim_gather["bytes"]
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
