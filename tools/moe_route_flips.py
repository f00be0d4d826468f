"""Whether the MoE's flipped routes are what keeps a bf16 model axis from
one rank's numbers: each MoE arch of ``chip_smoke.py`` phase 17, served
in bf16 at full width, its 4-layer cut (deepseek-v2-236b its 2), on one
rank and on a 1 x 2 gloo world on one card twice: routing freely, and
with every MoE call routed to one rank's experts (``forced_routes``:
the same weights from the call's own probabilities, the slots
recounted). Prints one JSON object an arch:
the flipped (token, choice) pairs, the dropped shares, and the logits'
and cache leaves' relative Frobenius error against one rank in each
run (and those of the decode steps alone); then the card's name and
power limit.

    python3 tools/moe_route_flips.py          # builds the kernels first

Phase 17's shapes and seeds (``chip_smoke._ma17_jobs``): a 1 x 4,096
prefill, 4 teacher-forced decode steps at batch 4 over 4,096 slots.
"""
import contextlib
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402

ARCHS = {"qwen3-moe-30b-a3b": 4, "deepseek-v2-236b": 2,
         "jamba-1.5-large-398b": 4}


@contextlib.contextmanager
def forced_routes(forced):
    """While open, the n-th ``layers.moe_route`` call routes to the
    experts of ``forced[n]`` (a ``chip_smoke.moe_routes`` record) instead
    of its own top-k: their weights from this call's probabilities, the
    capacity slots recounted."""
    import torch
    from repro_torch.models import layers as L
    route, n = L.moe_route, [0]

    def forced_route(p, xn, **kw):
        r = route(p, xn, **kw)
        topi = forced[n[0]][0].to(r.topi.device)
        n[0] += 1
        topv = r.probs.gather(1, topi)
        topv = (topv / torch.clamp(topv.sum(-1, keepdim=True),
                                   min=1e-9)).to(r.topv.dtype)
        ids = topi.view(r.groups, -1)
        onehot = (ids[..., None] == torch.arange(
            r.probs.shape[1], device=ids.device)).to(torch.int32)
        pos = torch.cumsum(onehot, 1, dtype=torch.int32).gather(
            -1, ids[..., None])[..., 0].view(topi.shape).long() - 1
        return r._replace(topi=topi, topv=topv, pos=pos, keep=pos < r.cap)

    L.moe_route = forced_route
    try:
        yield
    finally:
        L.moe_route = route


def child(argv):
    """A gloo rank of this tool: ``chip_smoke``'s ``--model-axis-child``,
    its serving jobs with a "forced" record run under ``forced_routes``."""
    serve = C._ma17_serve

    def serve_forced(dev, mesh, arch, job):
        if "forced" not in job:
            return serve(dev, mesh, arch, job)
        with forced_routes(job["forced"]):
            return serve(dev, mesh, arch, job)
    C._ma17_serve = serve_forced
    C.model_axis_child(int(argv[0]), int(argv[1]), *argv[2:6])


def main():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        C.fail("torch.cuda.is_available() is false: this needs a GPU")
    dev = resolve_device("cuda")
    build.load_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    base = C._ma17_jobs({a: get_config(a).vocab_size
                         for a in C.MA17_LAYERS})
    one, jobs = {}, {}
    for arch, layers in ARCHS.items():
        serve = dict(base[arch]["serve"], layers=layers)
        one[arch] = C._ma17_serve(dev, None, arch, serve)
        jobs[f"{arch} free"] = {"arch": arch, "serve": serve}
        jobs[f"{arch} forced"] = {"arch": arch, "serve": dict(
            serve, forced=one[arch]["routes"])}
    C.peak_and_reset()
    work = os.path.join(ROOT, "build", "moe_route_flips")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ranks = C._spawn_ranks(work, 2, {"mesh": (1, 2), "families": jobs,
                                     "work": work}, "flips", phase="flips",
                           env={"PYTORCH_CUDA_ALLOC_CONF":
                                "expandable_segments:True"},
                           script=os.path.abspath(__file__))
    for arch in ARCHS:
        want, row = one[arch], {"arch": arch, "layers": ARCHS[arch],
                                "dtype": "bfloat16", "card": card}
        for how in ("free", "forced"):
            got = ranks[0]["families"][f"{arch} {how}"]["serve"]
            saved = torch.load(os.path.join(work, f"w17_{arch} {how}.pt"),
                               weights_only=False)
            row[how] = {
                "ranks_same_logits": all(torch.equal(
                    r["families"][f"{arch} {how}"]["serve"]["logits"],
                    got["logits"]) for r in ranks),
                "flipped_pairs": C._flipped(got["routes"], want["routes"]),
                "flipped_pairs_decode": C._flipped(
                    got["routes"], want["routes"], want["prefill_routes"]),
                "dropped_share": C._dropped(got["routes"]),
                "dropped_share_one_rank": C._dropped(want["routes"]),
                "logits_rel_err": C._fro_rel(got["logits"], want["logits"]),
                "max_cache_leaf_rel_err": max(
                    C._fro_rel(a, b) if a.is_floating_point()
                    else float(not torch.equal(a, b))
                    for a, b in zip(saved["cache"], want["cache"]))}
        print(json.dumps(row), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    print(card)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--model-axis-child"]:
        child(sys.argv[2:])
    else:
        main()
