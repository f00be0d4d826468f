"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor any module of ``repro``; its entry points run on CUDA
unless asked for the CPU and raise otherwise; the knobs it dropped are
refused, not ignored, an unknown PCA solver is refused, and the cohort
knobs it has are routed."""
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
    assert int(count) >= 75, out.stdout
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
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--tokens", "1"])
    from repro_torch.launch import paper_repro
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paper_repro.main(["--rounds", "1"])
    from repro_torch.launch import federated_lm, train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        federated_lm.main(["--rounds", "1"])


@pytest.mark.parametrize("knob,value", [
    ("use_pallas_selection", True), ("batched_selection", True),
    ("select_per_cluster", 1), ("reset_upper_each_round", True),
    ("split_fraction", 0.34)])
def test_dropped_knobs_are_type_errors(knob, value):
    with pytest.raises(TypeError):
        FLConfig(**{knob: value})


@pytest.mark.parametrize("solver,error", [("randomized", None),
                                          ("lanczos", ValueError)])
def test_pca_solvers_are_accepted_or_refused(solver, error):
    """Both ported solvers are accepted; any other is a ``ValueError``."""
    if error is None:
        assert FLConfig(pca_solver=solver).pca_solver == solver
    else:
        with pytest.raises(error, match="unknown PCA solver"):
            FLConfig(pca_solver=solver)
    assert FLConfig().pca_solver == "exact"


@pytest.mark.parametrize("knob,value,engine", [
    ("distributed_selection", True, "distributed.cohort_round"),
    ("selection_chunk_size", 8, "rounds.client_round")])
def test_cohort_engines_are_accepted_and_routed(monkeypatch, knob, value,
                                                engine):
    """The two ported knobs are accepted: ``run_cohort`` routes the cohort
    to the cohort engine, and a chunk size leaves it on the client loop
    (the port selects one client at a time in every engine)."""
    from repro_torch.core import distributed as D
    from repro_torch.core import rounds
    from repro_torch.fl.comms import CommLedger
    from repro_torch.fl.transport import Channel

    class Routed(Exception):
        pass

    def stop(*args, **kwargs):
        raise Routed

    module, name = engine.split(".")
    monkeypatch.setattr({"distributed": D, "rounds": rounds}[module], name,
                        stop)
    cfg = get_wrn_config().reduced()
    ds = SyntheticImageDataset(40, image_size=cfg.image_size)
    clients = partition_k_shards(ds, num_clients=2, samples_per_client=20)
    model = make_split_wrn(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, torch.device("cpu"))
    fl = FLConfig(num_clients=2, **{knob: value})
    with pytest.raises(Routed):
        rounds.run_cohort(model, params, clients, fl,
                          rounds.GeneratorDraws(gen), Channel(CommLedger()),
                          ds.num_classes)


def test_unknown_codec_is_refused():
    with pytest.raises(ValueError):
        FLConfig(transport_codec="int4")
