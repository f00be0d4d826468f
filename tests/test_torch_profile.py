"""The cost model of the port (``repro_torch.obs.profile``): the
reference's ``TestProfiledJit`` cases in torch form — cost and
utilization on a span, one compile a signature, statics splitting
signatures, no work with the tracer off, a nested call inlined, ``.cost``
offline, the roofline terms and ``record_from_dryrun`` — and the parity
of ``roofline``, ``record_from_dryrun`` and the CPU peaks with
``repro``'s on the same inputs (level: exact); then what is the port's
own: the card's peaks, a ``captured`` span with no utilization, the
kernel entries' names and costs, and the LocalUpdate's sentinel."""
import numpy as np
import pytest
import torch

from repro.obs import profile as jprofile
from repro_torch import obs
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops
from repro_torch.launch import mesh
from repro_torch.obs import profile
from repro_torch.obs.profile import CostRecord, profiled


@profiled(name="mm_test", static_argnames=("scale",))
def _mm(a, b, scale=1.0):
    return scale * (a @ b)


def _arrays(n=32, m=16):
    rng = np.random.default_rng(0)
    return (torch.tensor(rng.normal(size=(n, m)), dtype=torch.float32),
            torch.tensor(rng.normal(size=(m, n)), dtype=torch.float32))


class TestProfiled:
    def test_cost_and_utilization_on_span(self):
        """Level: exact FLOPs (one 32 x 16 x 32 product, 2 M N K; the
        scale is element-wise, no FLOPs), the CPU's f32 peak."""
        a, b = _arrays()
        tr = obs.Tracer()
        with obs.use_tracer(tr):
            with obs.span("select"):
                _mm(a, b)
        sp = next(s for s in tr.spans if s.name == "select")
        assert sp.attrs["flops"] == 2 * 32 * 16 * 32
        # the product reads both inputs and writes 32 x 32; the scale
        # reads that and writes the scaled product
        assert sp.attrs["hbm_bytes"] == 4 * (2 * 32 * 16 + 3 * 32 * 32)
        assert sp.attrs["peak_flops"] == profile.peak_table(
            "cpu")["peak_flops_f32"]
        assert 0 < sp.attrs["utilization"]
        assert 0 < sp.attrs["hbm_utilization"]

    def test_sentinel_counts_each_signature_once(self):
        f = profiled(lambda x: x * 2, name="poly")
        tr = obs.Tracer()
        with obs.use_tracer(tr):
            for n in (4, 8, 16):            # three shapes = three compiles
                f(torch.zeros((n,)))
            for n in (4, 8, 16):            # repeats: no new compiles
                f(torch.zeros((n,)))
        counters = tr.metrics.snapshot()["counters"]
        assert counters["compile.poly"] == 3
        assert len([k for k in counters
                    if k.startswith("compile.poly.")]) == 3
        assert len([e for e in tr.events if e["name"] == "compile"]) == 3

    def test_static_argnames_split_signature(self):
        @profiled(name="mm_static", static_argnames=("scale",))
        def g(a, b, scale=1.0):
            return scale * (a @ b)

        a, b = _arrays()
        tr = obs.Tracer()
        with obs.use_tracer(tr):
            g(a, b, scale=1.0)
            g(a, b, scale=2.0)              # new static value -> recompile
            g(a, b, scale=2.0)              # cached
            g(a, b, 2.0)                    # positional: the same static
        assert tr.metrics.snapshot()["counters"]["compile.mm_static"] == 2

    def test_a_dynamic_python_value_is_not_a_signature(self):
        """A non-static Python value is data, as jit traces it: its type
        is in the signature, its value is not."""
        f = profiled(lambda x, first: x + first, name="dyn")
        tr = obs.Tracer()
        with obs.use_tracer(tr):
            for first in (0, 3, 7):
                f(torch.zeros(4), first)
        assert tr.metrics.snapshot()["counters"]["compile.dyn"] == 1

    def test_disabled_tracer_is_the_plain_call(self):
        """No tracer: the same bits as the function itself, and no
        signature or cost is ever derived."""
        f = profiled(lambda a, b: a @ b, name="plain")
        a, b = _arrays()
        out = f(a, b)
        assert torch.equal(out, a @ b)
        assert not f._counted and not f._costs

    def test_a_nested_call_is_part_of_its_callers_compile(self):
        """The counterpart of the reference's call inside a jax trace: a
        profiled function called while another runs inlines into it (no
        sentinel of its own, no cost on the span)."""
        inner = profiled(lambda x: x + 1, name="inner_fb")
        outer = profiled(lambda x: inner(x) * 2, name="outer_fb")
        tr = obs.Tracer()
        with obs.use_tracer(tr):
            with obs.span("s"):
                outer(torch.zeros(3, 4))
        counters = tr.metrics.snapshot()["counters"]
        assert "compile.inner_fb" not in counters
        assert counters["compile.outer_fb"] == 1

    def test_cost_offline(self):
        a, b = _arrays()
        cost = _mm.cost(a, b)
        assert isinstance(cost, CostRecord)
        assert cost.flops == 2 * 32 * 16 * 32
        assert cost.hbm_bytes > 0
        assert _mm.cost(a, b) is cost          # cached by signature

    def test_roofline_terms(self):
        cost = CostRecord(flops=1e12, hbm_bytes=1e9, collective_bytes=0.0)
        peaks = profile.peak_table("cpu")
        terms = profile.roofline(cost, peaks)
        assert set(terms) == {"compute_s", "memory_s", "collective_s",
                              "bound"}
        assert terms["bound"] in ("compute", "memory", "collective")

    def test_record_from_dryrun_roundtrip(self):
        rec = {"cost": {"flops_expanded": 5.0, "bytes_expanded": 7.0},
               "collectives": {"total_bytes": 3.0,
                               "unknown_trip_counts": 1}}
        c = profile.record_from_dryrun(rec)
        assert (c.flops, c.hbm_bytes, c.collective_bytes,
                c.unknown_trip_loops) == (5.0, 7.0, 3.0, 1)


# ---------------------------------------------------------------- parity

RECORDS = [
    {"cost": {"flops_expanded": 5.0, "bytes_expanded": 7.0,
              "transcendentals": 2.0},
     "collectives": {"total_bytes": 3.0, "unknown_trip_counts": 1}},
    {"cost": {"flops": 1.5e15, "bytes accessed": 2.5e11}},
    {"cost": {}, "collectives": {}},
    {},
]


@pytest.mark.parametrize("rec", RECORDS)
def test_record_from_dryrun_equals_the_references(rec):
    """Level: exact, field by field."""
    assert profile.record_from_dryrun(rec).as_dict() \
        == jprofile.record_from_dryrun(rec).as_dict()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cost", [
    (1e12, 1e9, 0.0), (1e9, 1e12, 0.0), (0.0, 0.0, 5e9), (3e14, 2e11, 4e8)])
def test_roofline_equals_the_references(cost, dtype):
    """Level: exact, on the CPU's peaks and on the card's (the
    reference's ``roofline`` over the port's H100 table)."""
    flops, hbm, coll = cost
    for peaks in (profile.peak_table("cpu"), profile.h100_peaks()):
        got = profile.roofline(CostRecord(flops=flops, hbm_bytes=hbm,
                                          collective_bytes=coll), peaks,
                               dtype)
        want = jprofile.roofline(jprofile.CostRecord(
            flops=flops, hbm_bytes=hbm, collective_bytes=coll), peaks, dtype)
        assert got == want


def test_cpu_peaks_equal_the_references():
    assert profile.peak_table("cpu") == jprofile.peak_table("cpu")


# ---------------------------------------------------------------- the port's

def test_card_peaks_are_the_h100s_and_no_other_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: mesh.H100_NAME)
    assert profile.peak_table("cuda") == {
        "peak_flops_bf16": mesh.H100_PEAK_FLOPS_BF16,
        "peak_flops_f32": mesh.H100_PEAK_FLOPS_F32,
        "hbm_bw": mesh.H100_HBM_BW, "ici_bw": mesh.H100_NVLINK_BW}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100"):
        profile.peak_table("cuda")


def test_a_captured_span_gets_no_utilization():
    """A span whose wall covers a CUDA graph capture (``captured``) keeps
    its count but computes no utilization, as the reference skips its
    ``traced`` spans; the same span uncaptured does."""
    tr = obs.Tracer()
    with obs.use_tracer(tr):
        for captured in (True, False):
            with obs.span("local_update") as sp:
                profile.charge_span(CostRecord(flops=1e6, hbm_bytes=1e6),
                                    (torch.zeros(2),))
                if captured:
                    sp.set(captured=True)
    cap, plain = tr.spans
    assert cap.attrs["flops"] == plain.attrs["flops"] == 1e6
    assert "utilization" not in cap.attrs
    assert "hbm_utilization" not in cap.attrs
    assert plain.attrs["utilization"] > 0


def test_bf16_calls_use_the_bf16_peak():
    f = profiled(lambda a: a * 2, name="half")
    tr = obs.Tracer()
    with obs.use_tracer(tr):
        with obs.span("s"):
            f(torch.zeros(4, dtype=torch.bfloat16))
    assert tr.spans[0].attrs["peak_flops"] == profile.peak_table(
        "cpu")["peak_flops_bf16"]


def test_lower_bound_counts_are_flagged():
    """A count with a data-decided loop (``unknown_trip_loops``) marks the
    span's cost a lower bound, as the reference's."""
    tr = obs.Tracer()
    with obs.use_tracer(tr):
        with obs.span("select"):
            profile.charge_span(CostRecord(flops=1.0, unknown_trip_loops=1))
    assert tr.spans[0].attrs["cost_is_lower_bound"] is True


@pytest.mark.parametrize("entry,name,args,want", [
    (ops._pdist, "kmeans_pairwise_dist_kernel",
     (torch.zeros(50, 8), torch.zeros(3, 8), torch.zeros(50, 3)),
     kcost.kmeans_pairwise_dist(50, 8, 3)),
    (ops._lloyd, "kmeans_lloyd_kernel",
     (torch.zeros(50, 8), torch.zeros(3, 8), torch.zeros(50, 3)) + (None,) * 5,
     kcost.kmeans_lloyd_step(50, 8, 3)),
    (ops._quant, "quantize_affine_kernel",
     (torch.zeros(10, 64), None, None, None, None),
     kcost.quantize_affine(10, 64)),
    (ops._quant_cohort, "quantize_affine_cohort_kernel",
     (torch.zeros(3, 10, 64), None, None, None, None),
     kcost.quantize_affine_batched(3, 10, 64)),
    (ops._flash, "flash_attention_kernel",
     (torch.zeros(1, 16, 4, 8, dtype=torch.bfloat16),
      torch.zeros(1, 16, 2, 8, dtype=torch.bfloat16), None, None, True, 0,
      "tensor_core", None),
     kcost.flash_attention(1, 16, 4, 2, 8)),
    (ops._flash_bwd, "flash_attention_bwd_kernel",
     (torch.zeros(1, 16, 4, 8), torch.zeros(1, 20, 2, 8)) + (None,) * 8
     + (False, 0, "cuda_core"),
     kcost.flash_attention_bwd(1, 16, 4, 2, 8, sk=20, causal=False,
                               dtype=torch.float32)),
    (ops._decode, "flash_decode_kernel",
     (torch.zeros(2, 1, 4, 8, dtype=torch.bfloat16),
      torch.zeros(2, 32, 2, 8, dtype=torch.bfloat16), None, None, None),
     kcost.flash_decode(2, 32, 4, 2, 8)),
])
def test_kernel_entries_carry_the_references_names_and_their_cost(
        entry, name, args, want):
    """Each launch is a profiled entry named as the reference's
    (``repro/kernels/ops.py:29-40``; the cohort quantize and the
    backward, which the reference has not, after their kernels), whose
    cost is ``kernels/cost.py``'s count of the launch. Level: exact."""
    assert entry.name == name
    got = entry.cost(*args)
    assert (got.flops, got.hbm_bytes, got.transcendentals) == tuple(
        float(v) for v in want)


def test_capturing_a_local_update_is_its_compile(monkeypatch):
    """``CapturedSteps.get`` reports each new capture as one
    ``compile.local_update_stack`` (the reference's name) and none for a
    key it holds."""
    from repro_torch.core import fedavg as fa

    class FakeStep:
        def __init__(self, *args):
            pass

    monkeypatch.setattr(fa, "CapturedStep", FakeStep)
    steps = fa.CapturedSteps()
    params = {"w": torch.zeros(3)}
    def loss(*args):
        return 0

    tr = obs.Tracer()
    with obs.use_tracer(tr):
        for n in (8, 8, 16, 8):
            steps.get(params, 0.1, torch.zeros(n, 3), torch.zeros(n),
                      torch.zeros(2, 4, dtype=torch.int64), loss)
    assert tr.metrics.snapshot()["counters"][
        "compile.local_update_stack"] == 2
    compiles = [e for e in tr.events if e["name"] == "compile"]
    assert len(compiles) == len(steps)


def test_a_local_update_step_counts_on_meta_tensors():
    """``CapturedStep.cost``'s count: one SGD step of the split WRN on
    meta tensors (its convolutions and their gradients), times the
    steps — what the LocalUpdate's span carries on the card."""
    from repro_torch.configs import get_wrn_config
    from repro_torch.core import fedavg as fa
    from repro_torch.core.split import make_split_wrn
    from repro_torch.launch import flop_analysis
    cfg = get_wrn_config().reduced()
    model = make_split_wrn(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        torch.device("cpu"))
    n, bs = 20, 4
    x = torch.zeros(n, cfg.image_size, cfg.image_size, 3)
    y = torch.zeros(n, dtype=torch.int64)
    sc, _ = flop_analysis.count(
        fa._sgd_step, model.loss, 0.1, params, x, y,
        torch.zeros(5, bs, dtype=torch.int64),
        torch.zeros(1, dtype=torch.int64), torch.zeros(5))
    convs = sum(v for k, v in sc.op_bytes.items() if "convolution" in k)
    assert sc.flops > 0 and convs > 0 and sc.bytes > convs
