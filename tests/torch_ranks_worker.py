"""One rank of ``tests/test_torch_ranks.py``: a process of a gloo world on
the CPU. It reads a job (``torch.save``d by the test), runs the port's FL
round over a 1-D "data" mesh (``run_round(mesh=)``), the selection of a
stacked cohort over that mesh (``select_metadata_sharded``) and the LM
train step over the smoke mesh's fed axis, and saves what it got for the
test to compare. It imports torch and ``repro_torch`` only.

    python tests/torch_ranks_worker.py RANK WORLD INIT_FILE JOB OUT
"""
import datetime
import sys

import torch
import torch.distributed as dist


def _bytes(params):
    return {k: v.numpy().tobytes() for k, v in params.items()}


def run(job):
    from repro_torch.core.distributed import (select_metadata_sharded,
                                              selection_mesh)
    from repro_torch.core.rounds import run_round
    from repro_torch.core.split import make_split_wrn
    from repro_torch.fl.comms import CommLedger
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim.optimizers import tree_leaves

    from repro_torch.core import rounds as R

    # this rank's own work: the clients it selects for and updates
    ran = {"extract_select": 0, "update_client": 0}
    for name in ran:
        def counted(*args, _name=name, _fn=getattr(R, name), **kwargs):
            ran[_name] += 1
            return _fn(*args, **kwargs)
        setattr(R, name, counted)
    fl = job["fl"]
    model = make_split_wrn(fl["wrn"])
    ledger = CommLedger()
    mesh = selection_mesh(device_type="cpu")
    res = run_round(model, fl["params"], model.split(fl["params"])[1],
                    fl["clients"], fl["cfg"], fl["draws"], ledger=ledger,
                    num_classes=10, mesh=mesh)
    out = {"fl": dict(global_params=_bytes(res.global_params),
                      composed_params=_bytes(res.composed_params),
                      ledger=ledger.summary(), losses=res.client_losses,
                      metadata_count=res.metadata_count, ran=dict(ran))}
    sel = job["sel"]
    got = select_metadata_sharded(sel["acts"], sel["labels"], sel["first"],
                                  mesh, **sel["knobs"])
    out["sel"] = (got.indices, got.valid, got.features, got.lloyd_iters)
    # the cohorts this rank trains: one selection each
    picks = []
    lm = job["lm"]
    step, _ = make_train_step(
        lm["cfg"], lm["tcfg"], mesh=make_smoke_mesh(device_type="cpu"),
        observe=lambda event, _: picks.append(1) if event == "selection"
        else None)
    for g, tokens, first in lm["cases"]:
        params = tree_map(lambda t: t[None].expand((g,) + tuple(t.shape)),
                          lm["params"])
        picks.clear()
        new, _, metrics = step(params, (), {"tokens": tokens}, first)
        out[f"lm_{g}"] = ([x[0].clone() for x in tree_leaves(new)],
                          {k: float(v) for k, v in metrics.items()},
                          len(picks))
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
