"""The port's input specs (``repro_torch.launch.specs``) against the
reference's (``repro.launch.specs``), and the plan's DTensor placements on
a 16 x 16 ``DeviceMesh`` over the fake process group, on the CPU.

``input_specs`` for a dense (llama3.2-1b), an MoE (qwen3-moe-30b-a3b), an
MLA (deepseek-v2-236b, FSDP) and an encoder-decoder (whisper-medium, its
frames) arch at full size, for ``train_4k``, ``prefill_32k``,
``decode_32k`` and ``long_500k``, on the (16, 16) and (2, 16, 16) meshes
(the reference's a stand-in ``AbstractMesh``, as in
``test_torch_sharding.py``); the train step's own split LM too. Level:
exact. Every leaf's shape, dtype and spec (params, batch, cache, tokens),
``g``, ``fed_axes``, and the plan's ``replicated`` and ``notes``. The
port's leaves are meta tensors: nothing is allocated.

The fake process group (``torch.testing._internal.distributed.fake_pg``)
holds 256 ranks in this one process, so ``make_production_mesh`` builds
the real 16 x 16 mesh here; the group is destroyed after the test.
"""
import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs import INPUT_SHAPES
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.launch.specs import input_specs as jinput_specs
from repro.launch.steps import make_train_step as jmake_train_step
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as sh
from repro_torch.launch.specs import Placed, input_specs
from repro_torch.launch.steps import make_train_step
from test_torch_sharding import sorted_leaves, stand_in

ARCHS = ["llama3.2-1b", "qwen3-moe-30b-a3b", "deepseek-v2-236b",
         "whisper-medium"]


def _leaves(tree):
    return [(tuple(p.tensor.shape), str(p.tensor.dtype).split(".")[-1],
             p.spec) for p in sorted_leaves(tree)]


def _jleaves(tree):
    return [(tuple(s.shape), str(s.dtype), tuple(s.sharding.spec))
            for s in jax.tree.leaves(tree)]


def _same(got, want, kind):
    assert _leaves(got["params"]) == _jleaves(want["params"])
    assert all(p.tensor.device.type == "meta"
               for p in sorted_leaves(got["params"]))
    assert got["plan"].replicated == want["plan"].replicated
    assert got["plan"].notes == want["plan"].notes
    if kind == "decode":
        assert _leaves(got["cache"]) == _jleaves(want["cache"])
        assert _leaves([got["tokens"]]) == _jleaves([want["tokens"]])
    else:
        assert sorted(got["batch"]) == sorted(want["batch"])
        for k in got["batch"]:
            assert _leaves([got["batch"][k]]) == _jleaves(
                [want["batch"][k]])
    if kind == "train":
        assert (got["g"], got["fed_axes"]) == (want["g"], want["fed_axes"])
        assert tuple(got["first"].tensor.shape) == (got["g"],)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, shape, mesh):
    jmesh, axes = stand_in(mesh)
    got = input_specs(get_config(arch), INPUT_SHAPES[shape], axes)
    want = jinput_specs(jget_config(arch), INPUT_SHAPES[shape], jmesh)
    assert got["mode"] == want["mode"]
    _same(got, want, want["mode"])


def test_input_specs_of_the_train_steps_own_lm():
    """The train step's LM is split at the paper's layer j: its specs
    follow its stages, as the reference's do."""
    jmesh, axes = stand_in("16x16")
    arch = "llama3.2-1b"
    _, jlm = jmake_train_step(jget_config(arch), JTrainConfig())
    _, lm = make_train_step(get_config(arch), TrainConfig())
    got = input_specs(get_config(arch), INPUT_SHAPES["train_4k"], axes,
                      lm=lm)
    want = jinput_specs(jget_config(arch), INPUT_SHAPES["train_4k"], jmesh,
                        lm=jlm)
    _same(got, want, "train")


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    yield
    dist.destroy_process_group()


def test_placements_on_a_16x16_device_mesh(fake_world):
    from torch.distributed.tensor import Replicate, Shard
    mesh = M.make_production_mesh(device_type="cpu")
    axes = M.mesh_axis_sizes(mesh)
    assert axes == {"data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="512 ranks, the world has 256"):
        M.make_production_mesh(multi_pod=True, device_type="cpu")
    for arch in ARCHS:
        specs = input_specs(get_config(arch), INPUT_SHAPES["train_4k"],
                            axes)
        plan = specs["plan"]
        placed = sorted_leaves(plan.placements(mesh))
        leaves = sorted_leaves(specs["params"])
        assert len(placed) == len(leaves)
        for pl, leaf in zip(placed, leaves):
            assert len(pl) == 2
            for i, name in enumerate(mesh.mesh_dim_names):
                dims = [d for d, e in enumerate(leaf.spec)
                        if e == name or (isinstance(e, tuple) and name in e)]
                if dims:
                    assert pl[i] == Shard(dims[0])
                    assert leaf.tensor.shape[dims[0]] % axes[name] == 0
                else:
                    assert pl[i] == Replicate()
    with pytest.raises(ValueError, match="the plan is for"):
        sh.Plan({"data": 2, "model": 2}, []).placements(mesh)


def test_a_mesh_must_span_the_world():
    """No process group: a mesh refuses; a smoke mesh's shape follows the
    world size."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        M.make_smoke_mesh(device_type="cpu")
    assert M.smoke_mesh_shape(1) == ((1, 1), ("data", "model"))
    assert M.smoke_mesh_shape(2) == ((2, 1), ("data", "model"))
    assert M.smoke_mesh_shape(4) == ((2, 2), ("data", "model"))
    assert M.smoke_mesh_shape(8, multi_pod=True) == (
        (2, 2, 2), ("pod", "data", "model"))
    assert isinstance(input_specs(get_config("llama3.2-1b"),
                                  INPUT_SHAPES["decode_32k"],
                                  {"data": 1, "model": 1})["tokens"], Placed)
