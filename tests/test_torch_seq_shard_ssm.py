"""Sequence-sharded activations in training for the SSM families:
``tests/test_torch_seq_shard.py``'s train cases (1 x 2, and 2 x 2 with
FSDP, G = 1, in f32) for reduced jamba-1.5-large-398b (cut to its first
2 layers: Mamba, Mamba + MoE; rows of ``T_MOE`` tokens, its MoE's
slots sent by an all-to-all) and rwkv6-3b: Mamba's scan and RWKV's
recurrence run along the positions gathered, on each rank's channels or
heads. W_G and the metrics within 2e-3 of the reference's unsharded
``make_train_step`` and within rtol 1e-5 / atol 1e-6 of the port's
one-rank step, every rank the same bits.
"""
import pytest

import test_torch_seq_shard as S
import torch_model_axis_families as F
from test_torch_round import one_torch_thread  # noqa: F401
from torch_once import once

JAMBA, RWKV = S.JAMBA, "rwkv6-3b"
ARCHS = (JAMBA, RWKV)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return once(tmp_path_factory, "seq_shard_ssm_worlds",
                lambda: _worlds(tmp_path_factory))


def _worlds(tmp_path_factory):
    procs, ports = S.spawn_train(tmp_path_factory.mktemp("seq_shard_ssm"),
                                 ARCHS, 91)
    one, ref = S.train_runs(ports)
    return dict(outs=F.join(procs), one=one, ref=ref)


@pytest.mark.parametrize("mesh", sorted(S.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_the_families_sequence_sharded_activations_match(worlds, arch,
                                                         mesh):
    S.check_families(worlds, arch, mesh, moe=arch == JAMBA)
