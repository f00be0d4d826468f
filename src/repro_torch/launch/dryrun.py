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

Per device, exactly (``"per_device_rule": "exact"`` on every record):
the count is what one rank runs, the rank at mesh coordinate 0 unless
``coord`` (``--coord``) names another, recorded as ``rank_coord``. The
step is made as on a mesh, over ``steps.rank_grid``'s groups, which only
name the rank's place (``Ranks(None, index, size)``), and called with
that rank's shards of the weights, the optimizer's state and the cache
as ``sharding.Placed`` meta tensors (the batch whole, as every rank takes
it): its share of the cohorts, the rows, the heads (every head its
columns touch, where the heads do not divide the model axis), the
experts, the vocabulary and a split ring's slots, FSDP's gathers, and
every collective it joins, charged by kind and bytes and not sent
(``core/collectives.py``). That holds on every mesh, the two-pod ones
and the ``--seq-shard-acts`` and ``--cache-seq-shard`` pairs included,
so the roofline's collective term is the rank's and ``hlo_flops_total``
(the rank's FLOPs times the chips) counts the replicated work.

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
from repro_torch.launch import flop_analysis
from repro_torch.launch.specs import Placed, input_specs
from repro_torch.launch.steps import (fed_ranks, make_decode_step,
                                      make_prefill_step, make_train_step,
                                      rank_grid, serve_ranks)
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


# a step's arguments by mode, and those a rank takes as its shards (the
# rest whole)
_ARGS = {"train": ("params", "opt_state", "batch", "first"),
         "prefill": ("params", "batch"),
         "decode": ("params", "cache", "tokens")}
_SHARDED = ("params", "opt_state", "cache")


def _tensors(tree: Any) -> Any:
    """The specs' tree with every ``Placed`` leaf replaced by its whole
    meta tensor."""
    if isinstance(tree, Placed):
        return tree.tensor
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return tree


def _local(tree: Any, axes: Dict[str, int]) -> Any:
    """The specs' tree as one device's shards, each a ``Placed`` of its
    spec: each dim of each meta tensor divided by the sizes of the axes
    its spec puts it on."""
    if isinstance(tree, Placed):
        shape = [n // _split(e, axes) for n, e in zip(tree.tensor.shape,
                                                      tree.spec)]
        shape += list(tree.tensor.shape[len(shape):])
        return Placed(torch.empty(shape, dtype=tree.tensor.dtype,
                                  device="meta"), tree.spec)
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


def build(cfg, shape, axes: Dict[str, int], tcfg: TrainConfig,
          cache_seq_shard: bool = False,
          coord: Optional[Dict[str, int]] = None):
    """-> (step, args, specs): the step as the rank at ``coord`` (0 on
    every axis by default) of a mesh of ``axes`` runs it
    (``steps.rank_grid``), its meta arguments that rank's (``_SHARDED``
    as its shards, the rest whole), and the specs."""
    _, force_swa, _ = resolve_mode(cfg, shape.name)
    grid = rank_grid(axes, coord)
    if shape.kind == "train":
        step, lm = make_train_step(cfg, tcfg,
                                   ranks=fed_ranks(cfg, grid, tcfg))
    elif shape.kind == "prefill":
        step, lm = make_prefill_step(cfg, force_swa=force_swa,
                                     ranks=serve_ranks(cfg, grid))
    else:
        step, lm = make_decode_step(cfg, force_swa=force_swa,
                                    cache_seq_shard=cache_seq_shard,
                                    ranks=serve_ranks(cfg, grid))
    specs = input_specs(cfg, shape, axes, tcfg, force_swa=force_swa, lm=lm,
                        cache_seq_shard=cache_seq_shard)
    args = tuple(_local(specs[k], axes) if k in _SHARDED
                 else _tensors(specs[k]) for k in _ARGS[specs["mode"]])
    return step, args, specs


def _memory(specs: Dict[str, Any], out: Any,
            axes: Dict[str, int]) -> Dict[str, Any]:
    """Argument and output bytes a device: the arguments by their specs,
    the outputs the rank's own (its shards of the weights or the cache,
    the whole logits or tokens every rank returns)."""
    arg = _device_bytes([specs[k] for k in _ARGS[specs["mode"]]], axes)
    return {"argument_size_in_bytes": arg,
            "output_size_in_bytes": flop_analysis.nbytes(out),
            "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None, "null_reason": NO_TEMP}


def run_one(arch: str, shape_name: str, *, multi_pod=False, smoke=False,
            tcfg: Optional[TrainConfig] = None, save_dir=None, tag="",
            mla_absorbed=False, cache_seq_shard=False, verbose=True,
            axes: Optional[Dict[str, int]] = None,
            shape_override: Optional[Dict[str, int]] = None,
            coord: Optional[Dict[str, int]] = None,
            cfg_override: Optional[Dict[str, Any]] = None):
    """Count one (arch, shape) pair -> its record (the reference's keys).
    ``axes`` replaces the mesh (default: the smoke or production mesh's
    axis sizes); ``shape_override`` replaces fields of the input shape
    (``seq_len``, ``global_batch``), after the smoke cut, and
    ``cfg_override`` fields of the config; ``coord`` names the rank
    counted (``build``)."""
    tcfg = tcfg or TrainConfig()
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    if mla_absorbed:
        cfg = dataclasses.replace(cfg, mla_absorbed=True)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
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
    coord = {a: (coord or {}).get(a, 0) for a in axes}
    nchips = math.prod(axes.values())
    t0 = monotonic()
    try:
        step, args, specs = build(cfg, shape, axes, tcfg,
                                  cache_seq_shard=cache_seq_shard,
                                  coord=coord)
        t_lower = monotonic() - t0
        with flop_analysis.counting() as sc:
            out = step(*args)
        t_compile = monotonic() - t0 - t_lower
        crec = profile.record_from_step(sc)
        coll = {"total_bytes": crec.collective_bytes,
                "bytes_by_kind": dict(sc.coll_bytes),
                "count_by_kind": dict(sc.coll_count),
                "unknown_trip_counts": crec.unknown_trip_loops}
        # the count is of every op the step runs, loops unrolled by their
        # Python trip counts: "expanded" as the reference's
        flops, nbytes = crec.flops, crec.hbm_bytes
        cost = {"flops": flops, "bytes accessed": nbytes,
                "transcendentals": crec.transcendentals,
                "flops_expanded": flops, "bytes_expanded": nbytes,
                "kernel_flops": dict(sc.kernel_flops),
                "kernel_bytes": dict(sc.kernel_bytes),
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
            memory=_memory(specs, out, axes), cost=cost,
            collectives=coll, hlo_bytes=None, mesh_axes=axes,
            rank_coord=coord, per_device_rule="exact")
        rec["roofline"] = roofline_terms(rec, tcfg)
        if verbose:
            r = rec["roofline"]
            print(f"[ok] {arch} x {shape_name}{' MP' if multi_pod else ''}"
                  f"{(' ' + tag) if tag else ''}: "
                  f"compute {r['compute_s']:.2e}s  memory {r['memory_s']:.2e}s"
                  f"  collective {r['collective_s']:.2e}s  -> {r['bound']}"
                  f"  (rank {tuple(coord.values())}; count "
                  f"{t_compile:.1f}s)")
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
    ap.add_argument("--coord", default=None,
                    help="the rank counted: its mesh coordinate, one index "
                         "an axis in the mesh's order (e.g. 1,0,3); "
                         "default 0 on every axis")
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

    coord = None
    if args.coord:
        names = ((SMOKE_MULTIPOD_AXES if args.multipod else SMOKE_AXES)
                 if args.smoke else
                 (MULTIPOD_AXES if args.multipod else PRODUCTION_AXES))
        coord = dict(zip(names, (int(c) for c in args.coord.split(","))))
    pairs = PAIRS if args.all else [(args.arch or "llama3.2-1b",
                                     args.shape or "train_4k")]
    results = []
    for arch, shape in pairs:
        results.append(run_one(arch, shape, multi_pod=args.multipod,
                               smoke=args.smoke, tcfg=tcfg,
                               save_dir=args.out, tag=args.tag,
                               mla_absorbed=args.mla_absorbed,
                               cache_seq_shard=args.cache_seq_shard,
                               coord=coord))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"\ndry-run: {n_ok} ok, {n_skip} skip, {n_err} error "
          f"of {len(results)}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
