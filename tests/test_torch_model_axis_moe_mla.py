"""The model axis for the MoE and MLA families: gloo worlds of 2 and 4
processes on the CPU (``tests/torch_model_axis_worker.py``, spawned once
each) run the port's tensor-parallel layers and steps on reduced
qwen3-moe-30b-a3b (4 experts, top 2, 4 heads over 2 kv heads) and
deepseek-v2-236b (MLA with 4 heads, a latent of 32; a dense layer, then
an MoE layer with a shared expert), in f32, on the same numpy inputs and
``params_from_jax`` weights as the reference.

(a) ``moe_apply`` (its output and aux) and ``mla_apply`` (without and
    with a q LoRA) on 1 x 2 and 1 x 4, the experts, heads and columns
    split as the train plan splits them, within 2e-3 of the reference's
    layer functions.
(b) Prefill (on both inference plans) and teacher-forced decode (10 steps
    over an 8-slot ring, which wraps) on 1 x 2, MLA's absorbed decode
    too: in f32 within 2e-3 of the reference's unsharded steps (the
    tokens equal to it and to the port's one rank), and the same steps
    in f64 within rtol 1e-5 / atol 1e-6 of the port's one-rank steps in
    f64 (``check_serve``: in f32 that level is below the one-rank step's
    own rounding on these models), every rank the same bits; each
    rank's attention calls on 2 of the 4 query heads.
(c) The train step with ``split_fl`` and one cluster a probe row on 1 x 2
    (G = 1) and 2 x 2 (G = 2): W_G leaf by leaf within 1e-5 of the port's
    one-rank step for both archs (the router's gradient, the replicated
    down-projections' and norms'), and within 2e-3 of the reference's
    ``make_train_step`` for qwen3-moe.
"""
import numpy as np
import pytest
import torch

import torch_model_axis_families as F
from repro_torch.configs import TrainConfig
from test_torch_round import one_torch_thread  # noqa: F401
from torch_once import once

MOE, MLA = "qwen3-moe-30b-a3b", "deepseek-v2-236b"
LAYERS = ("moe", "mla", "mla_q_lora")
MESHES = {"1x2": ((1, 2), 2, 1), "2x2": ((2, 2), 4, 2),
          "1x4": ((1, 4), 4, 1)}             # -> mesh, world, G
SERVE = (MOE, MLA, "absorbed")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return once(tmp_path_factory, "model_axis_moe_mla_worlds",
                lambda: _worlds(tmp_path_factory))


def _worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis_moe_mla")
    layers = {name: F.layer_inputs(name, 20 + i)
              for i, name in enumerate(LAYERS)}
    ports = {MOE: F.Port(MOE, 31, (1, 2)), MLA: F.Port(MLA, 33, (1, 2)),
             "absorbed": F.absorbed(F.Port(MLA, 33, (1,)))}
    jobs = {2: {}, 4: {}}
    for name, (params, x) in layers.items():
        for tag in ("1x2", "1x4"):
            mesh, world, _ = MESHES[tag]
            jobs[world][(name, tag)] = F.layer_case(name, mesh, params, x)
    for key, port in ports.items():
        if key == "absorbed":
            jobs[2].update(F.serve_cases(port, key, (1, 2), {"decode": 1}))
            continue
        jobs[2].update(F.serve_cases(port, key, (1, 2), {
            "prefill": ("decode", "prefill"), "decode": 1}))
        for g, world in ((1, 2), (2, 4)):
            jobs[world].update(port.cases(key, (g, 2), g, {"train": 1}))
    procs = {w: F._spawn(tmp, w, job) for w, job in jobs.items()}

    # meanwhile: the reference's layers and steps, the port's one rank
    ref = {name: F.reference_layer(name, *inputs)
           for name, inputs in layers.items()}
    one = {}
    for key, port in ports.items():
        for dtype in (torch.float32, torch.float64):
            one[(key, dtype)] = F.one_rank_serve(port, dtype)
        ref[key] = F.reference_serve(port)
    for arch in (MOE, MLA):
        for g in (1, 2):
            one[(arch, g)] = ports[arch].one_rank_train(
                g, TrainConfig(**F.TCFG))
    for g in (1, 2):
        ref[(MOE, "train", g)] = F.reference_train(ports[MOE], g)
    return dict(outs=F.join(procs), one=one, ref=ref)


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
@pytest.mark.parametrize("layer", LAYERS)
def test_layer_on_the_model_axis(worlds, layer, mesh):
    _, world, _ = MESHES[mesh]
    runs = F.ranks(worlds["outs"], world, (layer, mesh))
    got, heads = runs[0]
    want = worlds["ref"][layer]
    if layer == "moe":
        (got, aux), (want, want_aux) = got, want
        np.testing.assert_allclose(float(aux), want_aux, rtol=2e-3,
                                   atol=2e-3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    if layer != "moe":                   # 4 heads over the ranks
        assert all(h == [4 // world] for _, h in runs)


def _serve(worlds, arch, kind, *plan):
    """(every rank's f32 runs, every rank's f64 runs) of a serve case,
    checked (``check_serve``)."""
    runs = F.ranks(worlds["outs"], 2, (arch, kind) + plan)
    runs64 = F.ranks(worlds["outs"], 2, (arch + " f64", kind) + plan)
    F.check_serve(kind, runs[0][0], runs64[0][0],
                  worlds["one"][(arch, torch.float32)][kind],
                  worlds["one"][(arch, torch.float64)][kind],
                  worlds["ref"][arch][kind])
    return runs


@pytest.mark.parametrize("plan", ["decode", "prefill"])
@pytest.mark.parametrize("arch", [MOE, MLA])
def test_prefill_on_the_model_axis(worlds, arch, plan):
    runs = _serve(worlds, arch, "prefill", plan)
    assert all(h == [2] for _, h in runs)


@pytest.mark.parametrize("arch", SERVE)
def test_decode_on_the_model_axis(worlds, arch):
    runs = _serve(worlds, arch, "decode")
    # the absorbed form attends in plain torch (no kernel takes it)
    assert all(h == ([] if arch == "absorbed" else [2]) for _, h in runs)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", [MOE, MLA])
def test_train_step_on_the_model_axis(worlds, arch, mesh):
    _, world, g = MESHES[mesh]
    runs = F.ranks(worlds["outs"], world, (arch, "train"))
    (leaves, metrics), _ = runs[0]
    assert all(m == metrics for (_, m), _ in runs)
    assert metrics["selected"] == g * F.MB
    F.check_train((leaves, metrics), worlds["one"][(arch, g)],
                  worlds["ref"].get((arch, "train", g)))
