"""MLA and RWKV heads that do not divide the model axis: reduced
deepseek-v2-236b (MLA) and rwkv6-3b with 3 heads (``dataclasses.replace``
in both packages' configs) over 1 x 2, in f32, on the same numpy inputs
and ``params_from_jax`` weights as the reference run on the same replaced
configs (``tests/torch_model_axis_worker.py``, one gloo world of 2
processes). The plans split the flat (heads x width) dims mid-head
(1.5 heads a rank), so each rank computes every head its columns touch,
whole (``model_axis.frac_heads``: the boundary head on both ranks), and
passes only its own columns into ``wo`` (``model_axis.frac_cols``);
RWKV's decode runs every head on every rank over the state the plan
keeps whole.

Prefill (both inference plans) and teacher-forced decode (10 steps over
an 8-slot ring) in f32 within 2e-3 of the reference's unsharded steps
(the tokens equal to it and to the port's one rank's) and in f64 within
rtol 1e-5 / atol 1e-6 of the port's one-rank steps in f64
(``check_serve``); the train step (``split_fl``, one cluster a probe row,
G = 1) within 2e-3 of the reference's and 1e-5 of the port's one rank
(``check_train``); every rank the same bits. Each MLA rank runs its
attention kernels' plain versions on 2 of the 3 heads.
"""
import dataclasses

import pytest
import torch

import test_torch_model_axis as M
import torch_model_axis_families as F
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch.specs import step_plan
from repro_torch.models.transformer import LM
from test_torch_round import one_torch_thread  # noqa: F401
from torch_once import once

MLA, RWKV = "deepseek-v2-236b", "rwkv6-3b"
ARCHS = (MLA, RWKV)
HEADS = 3
KINDS = {"prefill": ("decode", "prefill"), "decode": 1}


def three_heads(cfg):
    return dataclasses.replace(cfg, num_heads=HEADS)


class ThreeHeads(M.Port):
    """``Port`` of an arch with ``HEADS`` heads in both packages."""

    def __init__(self, arch, seed):
        cfgs = M._cfgs
        M._cfgs = lambda a: tuple(three_heads(c) for c in cfgs(a))
        try:
            super().__init__(arch, seed, (1,))
        finally:
            M._cfgs = cfgs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return once(tmp_path_factory, "frac_heads_worlds",
                lambda: _worlds(tmp_path_factory))


def _worlds(tmp_path_factory):
    ports = {a: ThreeHeads(a, 101 + i) for i, a in enumerate(ARCHS)}
    job = {}
    for arch, port in ports.items():
        job.update(F.serve_cases(port, arch, (1, 2), KINDS))
        job.update(port.cases(arch, (1, 2), 1, {"train": 1}))
    procs = {2: F._spawn(tmp_path_factory.mktemp("frac_heads"), 2, job)}

    # meanwhile: the reference's unsharded steps, the port's one rank
    one, ref = {}, {}
    for arch, port in ports.items():
        for dtype in (torch.float32, torch.float64):
            one[(arch, dtype)] = F.one_rank_serve(port, dtype)
        one[(arch, "train")] = port.one_rank_train(1, TrainConfig(**M.TCFG))
        ref[arch] = F.reference_serve(port)
        ref[(arch, "train")] = F.reference_train(port, 1)
    return dict(outs=F.join(procs), one=one, ref=ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_plans_split_heads_mid_head(arch):
    """At 3 heads over 2 ranks each plan splits a head-wide dim into 1.5
    heads a rank: the train plan's key up-projection (RWKV's receptance)
    among them, decode's (head-aware) the leaves it does not
    replicate."""
    cfg = three_heads(get_config(arch).reduced())
    axes = {"pod": 1, "data": 1, "model": 2}
    name = "w_uk" if arch == MLA else "wr"
    for kind in ("train", "decode"):
        specs = step_plan(cfg, axes, kind, TrainConfig(), LM(cfg)
                          ).params["stages"][0][0]["mixer"]
        split = [k for k, v in specs.items() if "model" in v]
        assert split, (kind, specs)
        if kind == "train":
            assert name in split


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_heads_that_do_not_divide_serve(worlds, arch, kind):
    plans = KINDS["prefill"] if kind == "prefill" else ((),)
    for plan in plans:
        extra = (plan,) if kind == "prefill" else ()
        runs = F.ranks(worlds["outs"], 2, (arch, kind) + extra)
        runs64 = F.ranks(worlds["outs"], 2, (arch + " f64", kind) + extra)
        F.check_serve(kind, runs[0][0], runs64[0][0],
                      worlds["one"][(arch, torch.float32)][kind],
                      worlds["one"][(arch, torch.float64)][kind],
                      worlds["ref"][arch][kind])
        # MLA: 2 of the 3 heads a rank (the boundary head on both)
        assert all(h == ([2] if arch == MLA else []) for _, h in runs)


@pytest.mark.parametrize("arch", ARCHS)
def test_heads_that_do_not_divide_train(worlds, arch):
    runs = F.ranks(worlds["outs"], 2, (arch, "train"))
    (leaves, metrics), heads = runs[0]
    assert all(m == metrics for (_, m), _ in runs)
    F.check_train((leaves, metrics), worlds["one"][(arch, "train")],
                  worlds["ref"][(arch, "train")])
    assert heads == ([2] if arch == MLA else [])
