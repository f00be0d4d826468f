"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor any module of ``repro``; its entry points run on CUDA
unless asked for the CPU and raise otherwise; the knobs it has not ported
are refused, not ignored."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import FLConfig, get_wrn_config
from repro_torch.core.split import make_split_wrn
from repro_torch.data import SyntheticImageDataset, partition_k_shards
from repro_torch.device import resolve_device
from repro_torch.fl.simulation import FLSimulation

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names))
print(" ".join(bad))
"""


def test_every_module_imports_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = (out.stdout.splitlines() + ["", ""])[:2]
    assert int(count) >= 25, out.stdout
    assert bad == "", f"repro_torch pulled in: {bad}"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = get_wrn_config().reduced()
    ds = SyntheticImageDataset(40, image_size=cfg.image_size)
    clients = partition_k_shards(ds, num_clients=2, samples_per_client=20)
    with pytest.raises(RuntimeError):
        FLSimulation(make_split_wrn(cfg), clients, ds,
                     FLConfig(num_clients=2))
    from repro_torch.launch import quickstart
    with pytest.raises(RuntimeError):
        quickstart.main([])


@pytest.mark.parametrize("knob,value", [
    ("use_pallas_selection", True), ("batched_selection", True),
    ("select_per_cluster", 1), ("reset_upper_each_round", True),
    ("split_fraction", 0.34)])
def test_dropped_knobs_are_type_errors(knob, value):
    with pytest.raises(TypeError):
        FLConfig(**{knob: value})


@pytest.mark.parametrize("knob,value", [
    ("distributed_selection", True), ("selection_chunk_size", 8),
    ("pca_solver", "randomized"), ("observability", True)])
def test_unported_engines_are_refused(knob, value):
    with pytest.raises(NotImplementedError):
        FLConfig(**{knob: value})
    FLConfig(**{knob: getattr(FLConfig(), knob)})        # the default is fine


def test_unknown_codec_is_refused():
    with pytest.raises(ValueError):
        FLConfig(transport_codec="int4")
