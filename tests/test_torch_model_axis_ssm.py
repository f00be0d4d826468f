"""The model axis for the SSM families: gloo worlds of 2 and 4 processes on
the CPU (``tests/torch_model_axis_worker.py``, spawned once each) run the
port's tensor-parallel layers and steps on reduced jamba-1.5-large-398b
(8 layers: Mamba with d_inner 256, attention with 4 heads over 2 kv
heads every 4th layer, a 4-expert MoE every 2nd) and rwkv6-3b (4 heads
of 32, d_ff 256), in f32, on the same numpy inputs and
``params_from_jax`` weights as the reference.

(a) ``mamba_apply`` (``d_inner`` split: ``w_in``'s columns hold [u | z],
    gathered, both halves' chunk taken; ``dbc`` summed over the ranks),
    ``rwkv_apply`` (the heads split; ``ln_x``'s mean square over every
    head) and ``rwkv_ffn_apply`` on 1 x 2 and 1 x 4, within 2e-3 of the
    reference's layer functions.
(b) Prefill (on both inference plans) and teacher-forced decode (10 steps;
    the Mamba and RWKV states split over "model", RWKV's token shifts on
    d_model, gathered to be read) on 1 x 2, and rwkv6 on 1 x 4 on decode's
    plan, whose ``wk`` and ``wv`` are replicated (2 "kv heads" over 4
    ranks) and sliced a rank's heads: in f32 within 2e-3 of the
    reference's unsharded steps (the tokens equal to it and to the port's
    one rank), and the same steps in f64 within rtol 1e-5 / atol 1e-6 of
    the port's one-rank steps in f64 (``check_serve``), every rank the
    same bits.
(c) The train step with ``split_fl`` and one cluster a probe row on 1 x 2
    (G = 1) and 2 x 2 (G = 2): W_G leaf by leaf within 1e-5 of the port's
    one-rank step for both archs (the replicated leaves' gradients, the
    router's, RWKV's ``ln_x``), and within 2e-3 of the reference's
    ``make_train_step`` for rwkv6.
"""
import numpy as np
import pytest
import torch

import torch_model_axis_families as F
from repro_torch.configs import TrainConfig, get_config
from test_torch_round import one_torch_thread  # noqa: F401
from torch_once import once

JAMBA, RWKV = "jamba-1.5-large-398b", "rwkv6-3b"
LAYERS = ("mamba", "rwkv", "rwkv_ffn")
MESHES = {"1x2": ((1, 2), 2, 1), "2x2": ((2, 2), 4, 2),
          "1x4": ((1, 4), 4, 1)}             # -> mesh, world, G


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return once(tmp_path_factory, "model_axis_ssm_worlds",
                lambda: _worlds(tmp_path_factory))


def _worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis_ssm")
    layers = {name: F.layer_inputs(name, 40 + i)
              for i, name in enumerate(LAYERS)}
    ports = {JAMBA: F.Port(JAMBA, 51, (1, 2)), RWKV: F.Port(RWKV, 53, (1, 2))}
    jobs = {2: {}, 4: {}}
    for name, (params, x) in layers.items():
        for tag in ("1x2", "1x4"):
            mesh, world, _ = MESHES[tag]
            jobs[world][(name, tag)] = F.layer_case(name, mesh, params, x)
    for key, port in ports.items():
        jobs[2].update(F.serve_cases(port, key, (1, 2), {
            "prefill": ("decode", "prefill"), "decode": 1}))
        for g, world in ((1, 2), (2, 4)):
            jobs[world].update(port.cases(key, (g, 2), g, {"train": 1}))
    jobs[4].update(F.serve_cases(ports[RWKV], "rwkv 1x4", (1, 4), {
        "prefill": ("decode",), "decode": 1}))
    procs = {w: F._spawn(tmp, w, job) for w, job in jobs.items()}

    # meanwhile: the reference's layers and steps, the port's one rank
    ref = {name: F.reference_layer(name, *inputs)
           for name, inputs in layers.items()}
    one = {}
    for key, port in ports.items():
        for dtype in (torch.float32, torch.float64):
            one[(key, dtype)] = F.one_rank_serve(port, dtype)
        for g in (1, 2):
            one[(key, g)] = port.one_rank_train(g, TrainConfig(**F.TCFG))
        ref[key] = F.reference_serve(port)
    for g in (1, 2):
        ref[(RWKV, "train", g)] = F.reference_train(ports[RWKV], g)
    return dict(outs=F.join(procs), one=one, ref=ref)


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
@pytest.mark.parametrize("layer", LAYERS)
def test_layer_on_the_model_axis(worlds, layer, mesh):
    _, world, _ = MESHES[mesh]
    got, _ = F.ranks(worlds["outs"], world, (layer, mesh))[0]
    np.testing.assert_allclose(got.numpy(), worlds["ref"][layer],
                               rtol=2e-3, atol=2e-3)


def _serve(worlds, world, tag, arch, kind, *plan):
    """Every rank's f32 runs of a serve case, checked with its f64 runs
    (``check_serve``)."""
    runs = F.ranks(worlds["outs"], world, (tag, kind) + plan)
    runs64 = F.ranks(worlds["outs"], world, (tag + " f64", kind) + plan)
    F.check_serve(kind, runs[0][0], runs64[0][0],
                  worlds["one"][(arch, torch.float32)][kind],
                  worlds["one"][(arch, torch.float64)][kind],
                  worlds["ref"][arch][kind])
    return runs


@pytest.mark.parametrize("plan", ["decode", "prefill"])
@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_prefill_on_the_model_axis(worlds, arch, plan):
    runs = _serve(worlds, 2, arch, arch, "prefill", plan)
    # jamba's attention layers: 4 query heads over the ranks; rwkv none
    assert all(h == ([2] if arch == JAMBA else []) for _, h in runs)


@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_decode_on_the_model_axis(worlds, arch):
    _serve(worlds, 2, arch, arch, "decode")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_rwkv_on_four_ranks_with_wk_and_wv_replicated(worlds, kind):
    """At 1 x 4 decode's head-aware plan replicates ``wk`` and ``wv`` (2
    "kv heads" do not divide 4) and splits ``wr``, ``wg`` and ``wo``: each
    rank slices its head's columns of the replicated leaves."""
    from repro_torch.launch.specs import step_plan
    axes = {"pod": 1, "data": 1, "model": 4}
    specs = step_plan(get_config(RWKV).reduced(), axes,
                      "decode").params["stages"][0][0]["mixer"]
    assert specs["wk"] == specs["wv"] == (None, None, None)
    assert specs["wr"] == (None, None, "model")
    _serve(worlds, 4, "rwkv 1x4", RWKV, kind,
           *(("decode",) if kind == "prefill" else ()))


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", [JAMBA, RWKV])
def test_train_step_on_the_model_axis(worlds, arch, mesh):
    _, world, g = MESHES[mesh]
    runs = F.ranks(worlds["outs"], world, (arch, "train"))
    (leaves, metrics), _ = runs[0]
    assert all(m == metrics for (_, m), _ in runs)
    assert metrics["selected"] == g * F.MB
    F.check_train((leaves, metrics), worlds["one"][(arch, g)],
                  worlds["ref"].get((arch, "train", g)))
