"""The port's paper driver (``repro_torch.launch.paper_repro``, the twin of
``examples/paper_repro.py``) on the CPU at a reduced size: 2 rounds of 2
clients of the reduced WRN. It writes the reference driver's JSON keys and
a W_G checkpoint in the reference's tree, which restores into the port's
parameters and into ``repro``'s ``init_wrn`` tree; ``--no-selection`` (the
Table 2 baseline) runs too.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs.wrn_cifar import WRNConfig as JWRNConfig
from repro.models import wrn as jwrn
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_wrn_config
from repro_torch.core.split import make_split_wrn
from repro_torch.launch import paper_repro
from repro_torch.models import wrn
from test_torch_round import one_torch_thread  # noqa: F401

KEYS = {"config", "test_acc", "fedavg_acc", "metadata_counts",
        "selected_fraction", "comm", "wall_time_s"}
SMALL = ["--device", "cpu", "--rounds", "2", "--clients", "2",
         "--samples-per-client", "100"]


def test_defaults_leave_the_reference_result_alone():
    args = paper_repro.parse_args([])
    assert args.out == "experiments/paper_repro_torch.json"
    assert args.device == "cuda" and args.ckpt_dir is None


def test_paper_repro_writes_the_reference_keys_and_a_checkpoint(tmp_path):
    out_path, ck = tmp_path / "out.json", tmp_path / "ck"
    out = paper_repro.main(SMALL + ["--out", str(out_path), "--ckpt-dir",
                                    str(ck)])
    written = json.loads(out_path.read_text())
    assert set(written) == KEYS == set(out)
    assert len(written["test_acc"]) == len(written["fedavg_acc"]) == 2
    assert all(0 < m <= 2 * 2 * 4 for m in written["metadata_counts"])
    assert written["comm"]["up"]["metadata"] > 0
    assert ckpt.latest_step(str(ck)) == 2
    params = make_split_wrn(get_wrn_config().reduced()).init(
        torch.Generator().manual_seed(0), torch.device("cpu"))
    got, meta = ckpt.restore_checkpoint(str(ck), wrn.params_to_jax(params))
    assert meta["step"] == 2 and "FLConfig" in meta["cfg"]
    restored = wrn.params_from_jax(got)
    assert all(torch.isfinite(v).all() for v in restored.values())
    # the reference restores it into its own model's tree
    target = jax.tree.map(np.asarray, jwrn.init_wrn(
        JWRNConfig().reduced(), jax.random.PRNGKey(0)))
    jgot, _ = jckpt.restore_checkpoint(str(ck), target)
    for a, b in zip(jax.tree.leaves(jgot),
                    jax.tree.leaves(wrn.params_to_jax(restored))):
        assert a.tobytes() == b.tobytes()


def test_paper_repro_baseline_without_selection(tmp_path):
    out = paper_repro.main(SMALL + ["--no-selection", "--out",
                                    str(tmp_path / "b.json")])
    assert out["config"]["no_selection"] is True
    # Table 2: every map of the cohort goes up
    assert out["metadata_counts"] == [200, 200]


def test_paper_repro_needs_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paper_repro.main(["--rounds", "1", "--out",
                          str(tmp_path / "x.json")])
