"""Whether ``chip_smoke.py`` phase 18c's check of gemma3-4b's split
long_500k ring can tell a wrong merge of the ranks' softmax statistics
from a right one. The item (full width and depth, batch 1, 524,288 slots
over "data" on a 2 x 1 gloo world on one card, 393,216 positions filled,
4 teacher-forced decode steps) runs on one rank in bf16 and in f32 (the
same bf16 weights and cache values: the rounding floor), and on the
world, sound and with ``layers.merge_parts`` replaced by a wrong merge:
the ranks' parts weighed equally (``equal_weights``), or the second
rank's part dropped (``second_dropped``). Each runs with the keys drawn
N(0, 1) and again scaled 4x (``KEY_SCALES``; the smoke's
``P18_KEY_SCALE``): a peaked softmax, so that the attention's output is
not the near-zero mean of random values over 393,216 slots. Prints one
JSON object a run: the logits' relative Frobenius error against one
rank's bf16 decode, the ranks' and one rank's against the f32 decode and
their ratio (the check passes at ``MA_TOL`` or at a ratio of
``P18_FLOOR_RATIO``), the tokens' share equal to one rank's; then the
card's name and power limit.

    python3 tools/merge_faults.py          # builds the kernels first
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

TAG = "gemma3-4b long_500k"
KEY_SCALES = (1.0, 4.0)
FAULTS = ("sound", "equal_weights", "second_dropped")


def _variants():
    """tag -> (key scale, fault) of every run on the world, each
    registered in ``chip_smoke.P18_CACHES`` as the smoke's item."""
    return {f"{TAG} k{k} {f}": (k, f) for k in KEY_SCALES for f in FAULTS}


@contextlib.contextmanager
def wrong_merge(fault):
    """While open, ``layers.merge_parts`` merges wrongly as ``fault``
    says (``"sound"``: unchanged)."""
    from repro_torch.models import layers as L
    merge = L.merge_parts

    def equal_weights(os_, ls, dtype):
        return os_.mean(0).to(dtype)

    def second_dropped(os_, ls, dtype):
        return merge(os_[:1], ls[:1], dtype)
    if fault != "sound":
        L.merge_parts = {"equal_weights": equal_weights,
                         "second_dropped": second_dropped}[fault]
    try:
        yield
    finally:
        L.merge_parts = merge


def child(argv):
    """A gloo rank of this tool: ``chip_smoke``'s ``--model-axis-child``,
    each decode item under its ``wrong_merge``."""
    decode = C._p18_decode

    def faulty(dev, mesh, tag, job, dtype=None):
        with wrong_merge(job.get("fault", "sound")):
            return decode(dev, mesh, tag, job, dtype)
    C._p18_decode = faulty
    for tag in _variants():
        C.P18_CACHES[tag] = C.P18_CACHES[TAG]
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
    base = C._p18_jobs({a: get_config(a).vocab_size for a in {
        s[0] for s in C.P18_CACHES.values()} | set(C.P18_SERVE)})
    job = base["caches"][TAG]
    jobs = {}
    one = {}
    for tag, (scale, fault) in _variants().items():
        C.P18_CACHES[tag] = C.P18_CACHES[TAG]
        jobs[tag] = dict(job, key_scale=scale, fault=fault)
        if scale not in one:
            one[scale] = {
                "bf16": C._p18_decode(dev, None, tag, jobs[tag]),
                "f32": C._p18_decode(dev, None, tag, jobs[tag],
                                     dtype=torch.float32)}
    C.peak_and_reset()
    work = os.path.join(ROOT, "build", "merge_faults")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    items = [("cache", tag, C.P18_CACHES[TAG][2]) for tag in jobs]
    ranks = C._spawn_ranks(work, 2, {"mesh": items[0][2], "p18": {
        "jobs": {"caches": jobs}, "items": items}, "work": work},
        "merge_faults", phase="merge_faults",
        env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"},
        script=os.path.abspath(__file__))
    for tag, (scale, fault) in _variants().items():
        got = [r["p18"][("cache", tag)] for r in ranks]
        want = one[scale]
        to_f32 = C._fro_rel(got[0]["logits"], want["f32"]["logits"])
        one_f32 = C._fro_rel(want["bf16"]["logits"], want["f32"]["logits"])
        print(json.dumps({
            "item": TAG, "key_scale": scale, "merge": fault, "card": card,
            "ranks_same_logits": all(torch.equal(
                g["logits"], got[0]["logits"]) for g in got),
            "logits_rel_err_vs_one_rank": C._fro_rel(
                got[0]["logits"], want["bf16"]["logits"]),
            "ranks_vs_f32": to_f32, "one_rank_vs_f32": one_f32,
            "ratio": to_f32 / one_f32, "limit": C.MA_TOL,
            "ratio_limit": C.P18_FLOOR_RATIO,
            "tokens_equal_share": float((got[0]["tokens"]
                                         == want["bf16"]["tokens"]
                                         ).float().mean())}), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    print(card)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--model-axis-child"]:
        child(sys.argv[2:])
    else:
        main()
