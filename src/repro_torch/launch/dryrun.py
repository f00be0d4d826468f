"""The dry run: every (architecture x input shape) counted on a mesh
without a device — the port of ``repro.launch.dryrun``. For each pair it
builds the step (``launch/steps.py``) and its inputs as meta tensors
(``launch/specs.py``, at the mesh's axis sizes), counts the step's FLOPs,
bytes, transcendentals and collectives by running it on the meta device
(``launch/flop_analysis.py``, the port's counterpart of the reference's
compile and HLO parse), and reckons the three roofline terms over the
H100's data-sheet peaks (``obs.profile.roofline``, bf16). Nothing is
allocated, so the production meshes' pairs count on one CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod] [--out build/dryrun]
  ... --smoke   (the small mesh and the reduced configs: the CI path)

Per device. On a mesh whose model axis is 1 (the fed axis over ranks,
``launch/steps.py`` ``fed_ranks``) the count is one rank's, exactly — its
share of the cohorts with the collectives it joins (charged, not sent)
and the replicated meta steps; inference on each rank's shard of the
batch. A model axis above 1 (the production 16 x 16 and 2 x 16 x 16
meshes, the 2 x 2 smoke mesh) or FSDP is counted as the whole step's count
divided evenly over the chips, ``"per_device_rule": "even_split"``, a
lower bound on a rank's work with none of its collectives: one rank's
count of a tensor-parallel step is the last part of ``ROADMAP.md`` item
15b.

Of those even-split pairs the port now executes (``launch/steps.py`` on a
mesh) every family's on one pod: train_4k (``--seq-shard-acts``: the
hidden states split on the sequence over "model") and prefill_32k, with
jamba's and deepseek's weights over "data" (FSDP), RWKV or MLA heads
that do not divide the model axis (rwkv6-3b's 40 over 16) on every head
a rank's columns touch, and decode_32k and long_500k on every cache
``cache_plan`` makes (the k/v head dim over "model" where the kv heads
do not divide it, the sequence over "data" at long_500k's batch of 1, or
over "model" and ("data", "model") with ``--cache-seq-shard``). The dry
run still records them ``even_split``: a rank's own count of a
tensor-parallel or FSDP step is the rest of item 15b. The two-pod
meshes' inference still raises there.

``memory``: argument and output bytes a device from the specs (each leaf
divided over the axes its spec shards it on); there is no compiler, so
the temporaries are null with a reason (the card's measured peaks are
``chip_smoke.py``'s phases 9a and 14a).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, INPUT_SHAPES, TrainConfig, get_config
from repro_torch.core.collectives import Ranks
from repro_torch.launch import flop_analysis
from repro_torch.launch.specs import Placed, fed_layout, input_specs
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.registry import count_params
from repro_torch.obs import profile
from repro_torch.obs.timing import monotonic

SMOKE_AXES = {"data": 2, "model": 2}
SMOKE_MULTIPOD_AXES = {"pod": 2, "data": 2, "model": 2}
PRODUCTION_AXES = {"data": 16, "model": 16}
MULTIPOD_AXES = {"pod": 2, "data": 16, "model": 16}
NO_TEMP = ("no compiler: the temporaries are not planned ahead; the card's "
           "measured peaks are chip_smoke.py phases 9a and 14a")


def resolve_mode(cfg, shape_name: str):
    """(runnable?, force_swa, reason) — the reference's long_500k policy."""
    if shape_name != "long_500k":
        return True, False, ""
    mode = cfg.long_context_mode
    if mode == "skip":
        return False, False, f"{cfg.name}: long_500k outside family envelope"
    if mode in ("native", "state"):
        return True, False, ""
    return True, True, "swa-variant"   # dense archs: sliding-window variant


# a step's arguments by mode, and the argument its output mirrors (the
# train step's next params, the decode step's cache)
_ARGS = {"train": ("params", "batch", "first"), "prefill": ("params", "batch"),
         "decode": ("params", "cache", "tokens")}
_MIRRORED = {"train": ("params", 0), "decode": ("cache", 1)}


def _tensors(tree: Any) -> Any:
    """The specs' tree with every ``Placed`` leaf replaced by its meta
    tensor."""
    if isinstance(tree, Placed):
        return tree.tensor
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return tree


def _local(tree: Any, axes: Dict[str, int]) -> Any:
    """The specs' tree as one device's shards: each dim of each meta
    tensor divided by the sizes of the axes its spec puts it on."""
    if isinstance(tree, Placed):
        shape = [n // _split(e, axes) for n, e in zip(tree.tensor.shape,
                                                      tree.spec)]
        shape += list(tree.tensor.shape[len(shape):])
        return torch.empty(shape, dtype=tree.tensor.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _local(v, axes) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local(v, axes) for v in tree)
    return tree


def _split(entry: Any, axes: Dict[str, int]) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(axes.get(a, 1) for a in names)


def _device_bytes(tree: Any, axes: Dict[str, int]) -> int:
    """Bytes a device holds of a specs tree (its shards)."""
    if isinstance(tree, Placed):
        t = tree.tensor
        split = math.prod(_split(e, axes) for e in tree.spec)
        return t.numel() * t.element_size() // max(split, 1)
    if isinstance(tree, dict):
        return sum(_device_bytes(v, axes) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_device_bytes(v, axes) for v in tree)
    return 0


def per_device_rule(cfg, shape, axes: Dict[str, int]) -> str:
    """"exact" where the port executes this mesh (model axis 1, and the
    train step's "data" axis carrying cohorts, not FSDP), else
    "even_split"."""
    if axes.get("model", 1) > 1:
        return "even_split"
    if shape.kind == "train":
        _, fed_axes = fed_layout(cfg, axes)
        if axes.get("data", 1) > 1 and "data" not in fed_axes:
            return "even_split"
    return "exact"


def build(cfg, shape, axes: Dict[str, int], tcfg: TrainConfig,
          cache_seq_shard: bool = False):
    """-> (step, args, specs, rule): the step, its meta arguments as one
    device runs them under ``rule`` (``per_device_rule``), and the
    specs."""
    _, force_swa, _ = resolve_mode(cfg, shape.name)
    rule = per_device_rule(cfg, shape, axes)
    if shape.kind == "train":
        ranks = None
        if rule == "exact":
            _, fed_axes = fed_layout(cfg, axes)
            w = math.prod(axes.get(a, 1) for a in fed_axes)
            ranks = Ranks(None, 0, w) if w > 1 else None
        step, lm = make_train_step(cfg, tcfg, ranks=ranks)
    elif shape.kind == "prefill":
        step, lm = make_prefill_step(cfg, force_swa=force_swa)
    else:
        step, lm = make_decode_step(cfg, force_swa=force_swa)
    specs = input_specs(cfg, shape, axes, tcfg, force_swa=force_swa, lm=lm,
                        cache_seq_shard=cache_seq_shard)
    if specs["mode"] == "train":
        # every rank takes the whole round's arguments and runs its share
        args = (_tensors(specs["params"]), specs["opt_state"],
                _tensors(specs["batch"]), specs["first"].tensor)
    else:
        # inference: each device its shard of the batch (or, split evenly,
        # the whole step)
        shard = ((lambda t: _local(t, axes)) if rule == "exact"
                 else _tensors)
        args = tuple(shard(specs[k]) for k in _ARGS[specs["mode"]])
    return step, args, specs, rule


def _memory(specs: Dict[str, Any], out: Any, axes: Dict[str, int],
            rule: str, chips: int) -> Dict[str, Any]:
    """Argument and output bytes a device: the arguments by their specs;
    an output that mirrors an argument by that argument's spec, the rest
    as one device's whole (split evenly under "even_split")."""
    mode = specs["mode"]
    arg = _device_bytes([specs[k] for k in _ARGS[mode]], axes)
    rest, outb = out, 0
    if mode in _MIRRORED:
        key, i = _MIRRORED[mode]
        outb = _device_bytes(specs[key], axes)
        rest = [o for j, o in enumerate(out) if j != i]
    outb += flop_analysis.nbytes(rest) // (chips if rule == "even_split"
                                           else 1)
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": outb,
            "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None, "null_reason": NO_TEMP}


def run_one(arch: str, shape_name: str, *, multi_pod=False, smoke=False,
            tcfg: Optional[TrainConfig] = None, save_dir=None, tag="",
            mla_absorbed=False, cache_seq_shard=False, verbose=True,
            axes: Optional[Dict[str, int]] = None,
            shape_override: Optional[Dict[str, int]] = None):
    """Count one (arch, shape) pair -> its record (the reference's keys).
    ``axes`` replaces the mesh (default: the smoke or production mesh's
    axis sizes); ``shape_override`` replaces fields of the input shape
    (``seq_len``, ``global_batch``), after the smoke cut."""
    tcfg = tcfg or TrainConfig()
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    if mla_absorbed:
        cfg = dataclasses.replace(cfg, mla_absorbed=True)
    shape = INPUT_SHAPES[shape_name]
    if smoke:
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, 128),
            global_batch=min(shape.global_batch, 8))
    if shape_override:
        shape = dataclasses.replace(shape, **shape_override)
    ok, force_swa, reason = resolve_mode(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           "tag": tag, "status": "skip", "reason": reason}
    if not ok:
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {reason}")
        return rec

    if axes is None:
        axes = ((SMOKE_MULTIPOD_AXES if multi_pod else SMOKE_AXES) if smoke
                else (MULTIPOD_AXES if multi_pod else PRODUCTION_AXES))
    axes = dict(axes)
    nchips = math.prod(axes.values())
    t0 = monotonic()
    try:
        step, args, specs, rule = build(cfg, shape, axes, tcfg,
                                        cache_seq_shard=cache_seq_shard)
        t_lower = monotonic() - t0
        with flop_analysis.counting() as sc:
            out = step(*args)
        t_compile = monotonic() - t0 - t_lower
        split = nchips if rule == "even_split" else 1
        crec = profile.record_from_step(sc)
        coll = {"total_bytes": crec.collective_bytes,
                "bytes_by_kind": dict(sc.coll_bytes),
                "count_by_kind": dict(sc.coll_count),
                "unknown_trip_counts": crec.unknown_trip_loops}
        # the count is of every op the step runs, loops unrolled by their
        # Python trip counts: "expanded" as the reference's
        flops, nbytes = crec.flops / split, crec.hbm_bytes / split
        cost = {"flops": flops, "bytes accessed": nbytes,
                "transcendentals": crec.transcendentals / split,
                "flops_expanded": flops, "bytes_expanded": nbytes,
                "kernel_flops": {k: v / split
                                 for k, v in sc.kernel_flops.items()},
                "kernel_bytes": {k: v / split
                                 for k, v in sc.kernel_bytes.items()},
                "kernel_launches": dict(sc.kernel_launches)}
        rec.update(
            status="ok", chips=nchips, force_swa=force_swa,
            seq_len=shape.seq_len, global_batch=shape.global_batch,
            kind=shape.kind, t_lower_s=round(t_lower, 1),
            t_compile_s=round(t_compile, 1),
            params=count_params(cfg),
            active_params=count_params(cfg, active_only=True),
            nonembed_active_params=count_params(cfg, active_only=True,
                                                include_embed=False),
            memory=_memory(specs, out, axes, rule, nchips), cost=cost,
            collectives=coll, hlo_bytes=None, mesh_axes=axes,
            per_device_rule=rule)
        rec["roofline"] = roofline_terms(rec, tcfg)
        if verbose:
            r = rec["roofline"]
            print(f"[ok] {arch} x {shape_name}{' MP' if multi_pod else ''}"
                  f"{(' ' + tag) if tag else ''}: "
                  f"compute {r['compute_s']:.2e}s  memory {r['memory_s']:.2e}s"
                  f"  collective {r['collective_s']:.2e}s  -> {r['bound']}"
                  f"  ({rule}; count {t_compile:.1f}s)")
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[ERR] {arch} x {shape_name}: {type(e).__name__}: {e}")

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        suffix = ("_mp" if multi_pod else "") + (f"_{tag}" if tag else "")
        path = os.path.join(save_dir,
                            f"{arch.replace('.', '_')}_{shape_name}{suffix}.json")
        slim = {k: v for k, v in rec.items() if k != "trace"}
        with open(path, "w") as f:
            json.dump(slim, f, indent=1, default=str)
    return rec


def roofline_terms(rec: dict, tcfg: TrainConfig) -> dict:
    """The three roofline terms from the per-device numbers, via the one
    roofline calculator (``obs.profile.roofline``) over the H100's peaks
    at bf16, and the model FLOPs beside the counted ones."""
    chips = rec["chips"]
    crec = profile.record_from_dryrun(rec)
    flops_dev = crec.flops
    terms = profile.roofline(crec, profile.h100_peaks(), dtype="bf16")
    # MODEL_FLOPS: 6*N_active*D train (D = tokens this step), 2*N*D decode
    toks = rec["global_batch"] * (rec["seq_len"] if rec["kind"] != "decode"
                                  else 1)
    n = rec["nonembed_active_params"]
    if rec["kind"] == "train":
        toks_total = toks * tcfg.local_steps * (1 + tcfg.meta_steps * 0)
        model_flops = 6 * n * toks_total
    elif rec["kind"] == "prefill":
        model_flops = 2 * n * toks
    else:
        model_flops = 2 * n * toks
    hlo_total = flops_dev * chips
    terms.update(model_flops=model_flops, hlo_flops_total=hlo_total,
                 useful_ratio=(model_flops / hlo_total) if hlo_total else 0.0)
    return terms


PAIRS = [(a, s) for a in ARCHS for s in INPUT_SHAPES]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mla-absorbed", action="store_true")
    ap.add_argument("--local-steps", type=int, default=None)
    ap.add_argument("--no-split-fl", action="store_true")
    ap.add_argument("--seq-shard-acts", action="store_true",
                    help="H1: the train plan's head-aware layout")
    ap.add_argument("--cache-seq-shard", action="store_true",
                    help="H2: shard decode KV cache on seq over 'model'")
    ap.add_argument("--fedavg-bf16", action="store_true",
                    help="H3: bf16 delta all-reduce for FedAvg")
    args = ap.parse_args(argv)

    tkw = {}
    if args.local_steps is not None:
        tkw["local_steps"] = args.local_steps
    if args.no_split_fl:
        tkw["split_fl"] = False
    if args.seq_shard_acts:
        tkw["seq_shard_activations"] = True
    if args.fedavg_bf16:
        tkw["fedavg_compress"] = "bf16"
    tcfg = TrainConfig(**tkw)

    pairs = PAIRS if args.all else [(args.arch or "llama3.2-1b",
                                     args.shape or "train_4k")]
    results = []
    for arch, shape in pairs:
        results.append(run_one(arch, shape, multi_pod=args.multipod,
                               smoke=args.smoke, tcfg=tcfg,
                               save_dir=args.out, tag=args.tag,
                               mla_absorbed=args.mla_absorbed,
                               cache_seq_shard=args.cache_seq_shard))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"\ndry-run: {n_ok} ok, {n_skip} skip, {n_err} error "
          f"of {len(results)}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
