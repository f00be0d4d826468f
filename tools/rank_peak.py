"""A rank's peak bytes in one round of the train step, reckoned without a
device: the step made as the dry run makes it (``launch/dryrun.py``
``build``: the rank at mesh coordinate 0, its shards as meta tensors) and
run on the meta device, every storage an op makes counted from its
creation to the moment Python frees it; the peak is the most counted at
once, the rank's arguments included. It sees no allocator: no rounding to
blocks, no cache, no CUDA context, no workspace of a kernel (a kernel
wrapper's meta outputs only).

Against ``chip_smoke.py``'s card peaks (max_memory_allocated a rank, NVIDIA
H100 80GB HBM3, 700 W): 14b's rank (llama3.2-1b, 4 layers, 4 rows of 2,048
tokens, a cohort a rank) 19.99 GB here against 20.19 measured; 16b's 1 x 2
rank 10.15 against 10.35; 18b's deepseek-v2-236b layer (2 x 2, FSDP) 11.96
against 12.43. Phase 18 runs four ranks on one card, so each item's rank
must stay under a quarter of the card less the processes' contexts.

    PYTHONPATH=src python tools/rank_peak.py

Prints one JSON object, {item: {"axes", "cohorts", "rows", "tokens",
"arguments_bytes", "peak_bytes"}}.
"""
import dataclasses
import json
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import INPUT_SHAPES, TrainConfig, get_config
from repro_torch.launch import dryrun, flop_analysis, sharding
from repro_torch.launch.serve import cut_depth

# item -> (arch, layers, mesh axes, cohorts G, local steps, rows a cohort,
# tokens a row, FSDP planned); chip_smoke.py's train items and cuts
ITEMS = {
    "14b": ("llama3.2-1b", 4, {"data": 2, "model": 1}, 2, 2, 4, 2048, False),
    "16b 1x2": ("llama3.2-1b", 4, {"data": 1, "model": 2}, 1, 2, 4, 2048,
                False),
    "18b": ("deepseek-v2-236b", 1, {"data": 2, "model": 2}, 1, 2, 4, 2048,
            True),
    "18f-4 at 2,048 tokens": ("llama3.2-1b", 4,
                              {"pod": 2, "data": 2, "model": 1}, 4, 2, 4,
                              2048, False),
    "18f-4": ("llama3.2-1b", 4, {"pod": 2, "data": 2, "model": 1}, 4, 2, 4,
              1024, False),
    "18f-5 at 2,048 tokens": ("deepseek-v2-236b", 1,
                              {"pod": 2, "data": 2, "model": 1}, 2, 1, 4,
                              2048, True),
    "18f-5": ("deepseek-v2-236b", 1, {"pod": 2, "data": 2, "model": 1}, 2,
              1, 4, 512, True),
}


class LiveBytes(TorchDispatchMode):
    """Counts every storage an op returns while Python holds it."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.held = set()

    def hold(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self.held:                # a view, or written in place
            return
        self.held.add(key)
        n = s.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def free():
            self.live -= n
            self.held.discard(key)
        weakref.finalize(s, free)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.hold(t)
        return out


def peak(arch, layers, axes, g, local, rows, tokens, fsdp):
    cfg = cut_depth(get_config(arch), layers)
    tcfg = TrainConfig(local_steps=local, microbatch=rows,
                       meta_clusters=rows, meta_steps=2)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=tokens,
                                global_batch=g * rows)
    saved = sharding.FSDP_THRESHOLD
    sharding.FSDP_THRESHOLD = 0 if fsdp else saved
    try:
        step, args, specs = dryrun.build(cfg, shape, dict(axes), tcfg)
        assert specs["g"] == g, (specs["g"], g)
        live = LiveBytes()
        for t in tree_flatten(args)[0]:
            t = getattr(t, "tensor", t)
            if isinstance(t, torch.Tensor):
                live.hold(t)
        arguments = live.live
        with flop_analysis.counting(), live:
            step(*args)
    finally:
        sharding.FSDP_THRESHOLD = saved
    return {"axes": axes, "cohorts": g, "rows": rows, "tokens": tokens,
            "arguments_bytes": arguments, "peak_bytes": live.peak}


def main():
    print(json.dumps({item: peak(*spec) for item, spec in ITEMS.items()}))


if __name__ == "__main__":
    main()
