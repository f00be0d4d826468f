"""The port over ranks: gloo worlds of 2 and 3 processes on the CPU
(``tests/torch_ranks_worker.py``, spawned with a ``file://`` init method),
against the port's one-device engines and the reference.

(a) The FL round, WRN-10-1 at 16x16, 4 non-IID clients x 80 samples, int8
    (``test_torch_distributed.py``'s knobs), through ``run_round(mesh=)``
    over a 1-D "data" mesh (3 ranks pad the 4 clients to 6 with copies of
    client 0; each rank selects for and updates its share alone). Level:
    bit for bit the port's one-device cohort engine on
    the same draws (W_G(t), M_COM(t), ledger, losses, |D_M|), whose round
    holds to the reference's sequential ``run_round`` at
    ``test_torch_distributed.py``'s levels (ledger and |D_M| equal,
    weights and losses within 2e-3); the draws are the reference's
    (``JaxDraws``), recorded in the one-device run and replayed to the
    ranks. And ``select_metadata_sharded`` over the same mesh, 5 clients'
    stacked maps: bit for bit ``select_metadata_batched``'s Selection.
(b) The LM train step, a 4-layer reduced llama3.2-1b in f32
    (``test_torch_train_step.py``'s shapes), over the smoke mesh's fed
    axis: G = 2 and 4 on 2 ranks, G = 3 on 3, each rank training its G /
    w cohorts alone. Levels: every rank the same bits; within f32 rounding of the one-process step (the FedAvg
    sum's order differs: rtol 1e-5, atol 1e-6); within 2e-3 of the
    reference's ``make_train_step`` (G = 2 and 4).

The ranks' processes start first and run while this process computes
the reference's rounds. The archs above ``FSDP_THRESHOLD`` build their
train step on the smoke mesh with "data" over their rows and weights (the
fake process group stands in for the ranks; FSDP runs in
``test_torch_fsdp.py``, the model axis in ``test_torch_model_axis.py``).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.wrn_cifar import WRNConfig as JWRNConfig
from repro.core import rounds as jrounds
from repro.fl.comms import CommLedger as JCommLedger
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import wrn as jwrn
from repro_torch.configs import FLConfig, TrainConfig, get_config
from repro_torch.configs import get_wrn_config
from repro_torch.core import rounds
from repro_torch.core.selection import select_metadata_batched
from repro_torch.core.split import make_split_wrn
from repro_torch.data import SyntheticImageDataset, partition_k_shards
from repro_torch.fl.comms import CommLedger
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import wrn
from repro_torch.models.transformer import params_from_jax, tree_map
from repro_torch.optim.optimizers import tree_leaves
from test_torch_distributed import KNOBS
from test_torch_round import JaxDraws, one_torch_thread  # noqa: F401

TOL = 2e-3
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_ranks_worker.py")
SRC = os.path.join(os.path.dirname(os.path.dirname(WORKER)), "src")
L, N_MICRO, MB, T = 2, 2, 4, 16
CASES = {2: (2, 4), 3: (3,)}          # world size -> the G's it runs


def _bytes(params):
    return {k: v.numpy().tobytes() for k, v in params.items()}


def _lm_inputs(g):
    toks = np.random.default_rng(g).integers(
        0, 512, (g, L, N_MICRO, MB, T)).astype(np.int32)
    key = jax.random.PRNGKey(3 + g)
    first = [int(jax.random.categorical(k, jnp.zeros(MB)))
             for k in jax.random.split(key, g)]
    return toks, key, first


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    # (a) the reference's round and the port's one-device engine on its
    # draws, recorded
    wcfg = get_wrn_config().reduced()
    train = SyntheticImageDataset(500, image_size=wcfg.image_size,
                                  modes_per_class=3, seed=4)
    clients = partition_k_shards(train, num_clients=4, k_classes=2,
                                 samples_per_client=80, seed=4)
    k_init, k_round = jax.random.split(jax.random.PRNGKey(3))
    jm = jwrn.make_split_wrn(JWRNConfig().reduced())
    jparams = jm.init(k_init)
    jled = JCommLedger()
    jres = jrounds.run_round(jm, jparams, jm.split(jparams)[1], clients,
                             JFLConfig(batched_selection=False, **KNOBS),
                             k_round, ledger=jled, num_classes=10)
    model = make_split_wrn(wcfg)
    params = wrn.params_from_jax(jax.tree.map(np.asarray, jparams))
    cfg = FLConfig(distributed_selection=True, **KNOBS)
    rec = rounds.RecordingDraws(JaxDraws(k_round, len(clients)))
    led = CommLedger()
    one = rounds.run_round(model, params, model.split(params)[1], clients,
                           cfg, rec, ledger=led, num_classes=10)

    # (b) a 4-layer reduced llama in f32 from the reference's weights
    jcfg = dataclasses.replace(jget_config("llama3.2-1b").reduced(),
                               num_layers=4)
    lcfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                               num_layers=4)
    knobs = dict(dtype="float32", microbatch=MB, meta_clusters=MB)
    jstep, jlm = jmake_train_step(jcfg, JTrainConfig(**knobs))
    step, lm = make_train_step(lcfg, TrainConfig(**knobs))
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(1)))
    lparams = params_from_jax(tree, lcfg, lm=lm)

    # a stacked cohort's maps for the sharded selection
    gen = torch.Generator().manual_seed(8)
    sel = dict(acts=torch.randn(5, 60, 8, generator=gen),
               labels=torch.randint(3, (5, 60), generator=gen),
               knobs=dict(num_classes=3, clusters_per_class=2,
                          pca_components=4, kmeans_iters=5))
    sel["first"] = torch.stack([torch.stack([
        torch.nonzero(y == c)[0, 0] for c in range(3)])
        for y in sel["labels"]])
    batched = select_metadata_batched(sel["acts"], sel["labels"],
                                      sel["first"], **sel["knobs"])

    # the ranks, all started before the references below run
    procs = []
    for world, gs in CASES.items():
        job = dict(sel=sel,
                   fl=dict(wrn=wcfg, params=params, clients=clients, cfg=cfg,
                           draws=rec.replay()),
                   lm=dict(cfg=lcfg, tcfg=TrainConfig(**knobs),
                           params=lparams,
                           cases=[(g, torch.from_numpy(_lm_inputs(g)[0]),
                                   _lm_inputs(g)[2]) for g in gs]))
        job_path = str(tmp / f"job_{world}.pt")
        torch.save(job, job_path)
        for r in range(world):
            out = str(tmp / f"out_{world}_{r}.pt")
            procs.append((world, r, out, subprocess.Popen(
                [sys.executable, WORKER, str(r), str(world),
                 str(tmp / f"init_{world}"), job_path, out],
                env={**os.environ, "PYTHONPATH": SRC},
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))

    # meanwhile: one process's step and the reference's
    lm_one, lm_ref = {}, {}
    for world, gs in CASES.items():
        for g in gs:
            toks, key, first = _lm_inputs(g)
            new, _, m = step(tree_map(
                lambda t: t[None].expand((g,) + tuple(t.shape)), lparams),
                (), {"tokens": torch.from_numpy(toks)}, first)
            lm_one[g] = ([x[0] for x in tree_leaves(new)],
                         {k: float(v) for k, v in m.items()})
            if g in (2, 4):
                jp = jax.tree.map(lambda x: jnp.broadcast_to(
                    jnp.asarray(x)[None], (g,) + x.shape), tree)
                jnew, _, jm_ = jax.jit(jstep)(jp, (), {"tokens":
                                                      jnp.asarray(toks)},
                                              key)
                lm_ref[g] = ([np.asarray(x[0]) for x in
                              jax.tree.leaves(jnew)],
                             {k: float(v) for k, v in jm_.items()})

    outs = {}
    for world, r, out, proc in procs:
        try:
            log, _ = proc.communicate(timeout=400)
        finally:
            proc.kill()
        assert proc.returncode == 0, f"rank {r} of {world}:\n{log[-3000:]}"
        outs[(world, r)] = torch.load(out, weights_only=False)
    return dict(outs=outs, one=one, led=led, jres=jres, jled=jled,
                lm_one=lm_one, lm_ref=lm_ref, batched=batched, model=model,
                params=params, clients=clients, cfg=cfg,
                draws=rec.replay())


@pytest.mark.parametrize("world", sorted(CASES))
def test_fl_round_over_ranks_is_the_one_device_engine(ranked, world):
    one = ranked["one"]
    share = -(-4 // world)               # the padded cohort's share a rank
    for r in range(world):
        got = ranked["outs"][(world, r)]["fl"]
        # each rank selected for and updated its own share only
        assert got["ran"] == {"extract_select": share,
                              "update_client": share}
        assert got["global_params"] == _bytes(one.global_params)
        assert got["composed_params"] == _bytes(one.composed_params)
        assert got["ledger"] == ranked["led"].summary()
        assert got["losses"] == one.client_losses
        assert got["metadata_count"] == one.metadata_count


@pytest.mark.parametrize("world", sorted(CASES))
def test_sharded_selection_is_the_batched_one(ranked, world):
    want = ranked["batched"]
    for r in range(world):
        indices, valid, features, sweeps = ranked["outs"][(world, r)]["sel"]
        assert torch.equal(indices, want.indices)
        assert torch.equal(valid, want.valid)
        assert features.numpy().tobytes() == want.features.numpy().tobytes()
        assert sweeps == want.lloyd_iters


def test_run_round_distributed_is_the_engines_round(ranked):
    """``run_round_distributed`` (no mesh here) is ``run_round`` with the
    cohort engine, bit for bit, whatever the config's engine knob."""
    from repro_torch.core.distributed import run_round_distributed
    model, params = ranked["model"], ranked["params"]
    led = CommLedger()
    got = run_round_distributed(
        model, params, model.split(params)[1], ranked["clients"],
        dataclasses.replace(ranked["cfg"], distributed_selection=False),
        ranked["draws"], ledger=led, num_classes=10)
    assert led.summary() == ranked["led"].summary()
    assert _bytes(got.global_params) == _bytes(ranked["one"].global_params)
    assert _bytes(got.composed_params) == _bytes(
        ranked["one"].composed_params)


def test_the_one_device_engine_holds_to_the_reference(ranked):
    one, jres = ranked["one"], ranked["jres"]
    assert ranked["led"].summary() == ranked["jled"].summary()
    assert one.metadata_count == jres.metadata_count
    np.testing.assert_allclose(one.client_losses, jres.client_losses,
                               rtol=TOL, atol=TOL)
    for port, ref in [(one.global_params, jres.global_params),
                      (one.composed_params, jres.composed_params)]:
        for a, b in zip(jax.tree.leaves(wrn.params_to_jax(port)),
                        jax.tree.leaves(ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("world,g", [(w, g) for w, gs in CASES.items()
                                     for g in gs])
def test_train_step_over_ranks(ranked, world, g):
    runs = [ranked["outs"][(world, r)][f"lm_{g}"] for r in range(world)]
    # each rank trained (and selected for) its G / world cohorts alone
    assert [cohorts for _, _, cohorts in runs] == [g // world] * world
    for leaves, metrics, _ in runs[1:]:          # every rank the same bits
        assert metrics == runs[0][1]
        assert all(torch.equal(a, b) for a, b in zip(leaves, runs[0][0]))
    leaves, metrics, _ = runs[0]
    one_leaves, one_metrics = ranked["lm_one"][g]
    assert metrics["selected"] == one_metrics["selected"]
    for a, b in zip(leaves, one_leaves):         # f32 rounding of one rank
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for k in metrics:
        assert abs(metrics[k] - one_metrics[k]) <= 1e-5 * (
            1 + abs(one_metrics[k]))
    if g in ranked["lm_ref"]:                    # the reference's level
        ref_leaves, ref_metrics = ranked["lm_ref"][g]
        assert len(ref_leaves) == len(leaves)
        for a, b in zip(leaves, ref_leaves):
            np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL)
        for k in metrics:
            np.testing.assert_allclose(metrics[k], ref_metrics[k], rtol=TOL,
                                       atol=TOL)


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def join(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    yield join
    dist.destroy_process_group()


@pytest.mark.parametrize("world,arch", [
    (4, "jamba-1.5-large-398b"), (2, "deepseek-v2-236b")])
def test_the_train_step_shards_the_huge_archs_over_data(fake_world, world,
                                                        arch):
    """On the smoke mesh (2 x 2 at 4 ranks, 2 x 1 at 2) the archs above
    ``FSDP_THRESHOLD`` run G = 1 with no fed axis: "data" splits each
    cohort's rows and shards the weights (FSDP), "model" runs tensor
    parallel. The step builds; ``tests/test_torch_fsdp.py`` runs it."""
    from repro_torch.launch.steps import fed_ranks
    fake_world(world)
    mesh = make_smoke_mesh(device_type="cpu")
    cfg = get_config(arch)
    make_train_step(cfg, TrainConfig(), mesh=mesh)
    fed, model, data, _ = fed_ranks(cfg, mesh, TrainConfig())
    assert fed is None and data is not None and data.size == 2
    assert (model is not None) == (world == 4)


def test_a_mesh_needs_the_cohort_engine(fake_world):
    """The client-by-client loop takes no mesh: a round on one with the
    loop (or without selection) raises, not quietly runs on one rank."""
    from repro_torch.core.distributed import selection_mesh
    fake_world(2)
    mesh = selection_mesh(device_type="cpu")
    for knobs in (dict(distributed_selection=False),
                  dict(distributed_selection=True, use_selection=False)):
        with pytest.raises(ValueError, match="cohort engine"):
            rounds.run_cohort(None, {}, [], FLConfig(**knobs), None, None,
                              10, mesh=mesh)


def test_recorded_draws_replay_the_round(tmp_path):
    """``RecordingDraws`` hands out its inner draws and keeps host copies;
    its ``replay()`` pickles and gives them back (a ``meta_perms`` call of
    other sizes, or a cohort, raises)."""
    wcfg = get_wrn_config().reduced()
    train = SyntheticImageDataset(60, image_size=wcfg.image_size, seed=1)
    clients = partition_k_shards(train, num_clients=2, k_classes=2,
                                 samples_per_client=20, seed=1)
    rec = rounds.RecordingDraws(rounds.GeneratorDraws(
        torch.Generator().manual_seed(2)))
    handed = [rec.client(i, c, 10, 2) for i, c in enumerate(clients)]
    perms = rec.meta_perms(7, 3)
    torch.save(rec.replay(), tmp_path / "draws.pt")
    again = torch.load(tmp_path / "draws.pt", weights_only=False)
    for i, (c, d) in enumerate(zip(clients, handed)):
        got = again.client(i, c, 10, 2)
        assert torch.equal(got.first_centres, d.first_centres)
        assert torch.equal(got.local_perms, d.local_perms)
    assert torch.equal(again.meta_perms(7, 3), perms)
    with pytest.raises(ValueError, match="recorded"):
        again.meta_perms(8, 3)
    for draws in (rec, again):
        with pytest.raises(NotImplementedError):
            draws.cohort(4, 2)
