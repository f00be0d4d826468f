"""The port's LM training entry points on the CPU.

``python -m repro_torch.launch.train`` (the twin of
``repro.launch.train``): ``--smoke --device cpu --steps 2`` prints the
reference's lines (``round t: {...}  (x.xxs)`` with the reference's metric
keys, then ``train: done``), and its ``--ckpt-dir`` checkpoint restores
under ``repro.checkpoint`` into the reference's tree of the same model
bit for bit.

``python -m repro_torch.launch.federated_lm`` (the twin of
``examples/federated_lm.py``) runs its 3 rounds, and each round must sit
in a band around the reference's run of the same config on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python examples/federated_lm.py
    round 0: selected 24 seqs (6.2% of client data), meta loss 7.669, composed next-token acc 0.002
    round 1: selected 24 seqs (6.2% of client data), meta loss 7.577, composed next-token acc 0.002
    round 2: selected 24 seqs (6.2% of client data), meta loss 7.352, composed next-token acc 0.002

The reference's numbers are copied here, not recomputed: its run takes
about 46 s on a CPU (wall time of the command above), past the suite's
budget; the port's takes about 5 s. The band: the same selected count
(4 clients x 6 clusters, every cluster filled), the composed model's
next-token accuracy within 0.01 of the reference's, and the last
meta-training loss within 0.25 of the reference's each round (the two
packages draw their weights, K-means first centres and meta-training
orders from different generators, so they agree in level, not in bits).
A change of JAX or of its random streams moves the reference's level;
re-run the command and update ``REF`` then.
"""
import ast
import re

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.launch.steps import make_train_step as jmake_train_step
from repro_torch import checkpoint as ckpt
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch import federated_lm, train
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import tree_map
from test_torch_round import one_torch_thread  # noqa: F401

# examples/federated_lm.py on the CPU: (selected, meta loss, acc) a round
REF = [(24, 7.669, 0.002), (24, 7.577, 0.002), (24, 7.352, 0.002)]
ACC_BAND, LOSS_BAND = 0.01, 0.25
ROUND = re.compile(r"^round (\d+): (\{.*\})  \((\d+\.\d\d)s\)$")


@pytest.mark.parametrize("split_fl", [True, False])
def test_train_prints_the_reference_lines(capsys, split_fl):
    argv = ["--smoke", "--device", "cpu", "--steps", "2"]
    if not split_fl:
        argv.append("--no-split-fl")
    assert train.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "train: done" and len(lines) == 3
    keys = {"loss", "meta_loss", "selected"} if split_fl else {"loss"}
    for t, line in enumerate(lines[:2]):
        m = ROUND.match(line)
        assert m and int(m.group(1)) == t, line
        metrics = ast.literal_eval(m.group(2))   # the reference's dict
        assert set(metrics) == keys
        assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("asked,env,cards,want", [
    ("cuda:1", {}, 2, "cuda:1"),
    ("cuda", {}, 2, "cuda"),
    ("cpu", {"WORLD_SIZE": "2", "LOCAL_RANK": "1"}, 2, "cpu"),
    ("cuda:0", {"WORLD_SIZE": "2", "LOCAL_RANK": "1"}, 2, "cuda:1"),
    ("cuda", {"WORLD_SIZE": "4", "LOCAL_RANK": "3"}, 2, "cuda:1")])
def test_rank_device(asked, env, cards, want):
    """Outside torchrun the device asked for, its index kept; under it
    card LOCAL_RANK mod the cards."""
    assert train.rank_device(torch.device(asked), env, cards) == (
        torch.device(want))


def test_train_checkpoint_restores_under_the_reference(tmp_path):
    ck = str(tmp_path / "ck")
    assert train.main(["--smoke", "--device", "cpu", "--steps", "2",
                       "--ckpt-dir", ck]) == 0
    assert ckpt.latest_step(ck) == 1
    # the reference's tree of the same model (train's split stage list)
    jcfg = jget_config("llama3.2-1b").reduced()
    _, jlm = jmake_train_step(jcfg, JTrainConfig())
    jtree, jmeta = jckpt.CheckpointManager(ck).restore(
        jlm.init(jax.random.PRNGKey(0)))
    _, lm = make_train_step(get_config("llama3.2-1b").reduced(),
                            TrainConfig())
    tree, meta = ckpt.restore_checkpoint(ck, lm.init(
        torch.Generator().manual_seed(0)))
    assert jmeta["arch"] == meta["arch"] == "llama3.2-1b"
    assert jmeta["step"] == meta["step"] == 1
    got = jax.tree.leaves(jax.tree.map(np.asarray, jtree))
    want = jax.tree.leaves(tree_map(lambda t: t.numpy(), tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_federated_lm_holds_the_reference_band():
    out = federated_lm.main(["--device", "cpu", "--rounds", "3"])
    assert len(out) == len(REF)
    for got, (selected, loss, acc) in zip(out, REF):
        assert got["selected"] == selected
        assert abs(got["acc"] - acc) <= ACC_BAND, (got, acc)
        assert abs(got["meta_loss"] - loss) <= LOSS_BAND, (got, loss)
    losses = [r["meta_loss"] for r in out]
    assert losses == sorted(losses, reverse=True)   # it learns, as there
