"""The int8 quantize kernel's launch plans (``kernels/quantize.py``
``plan_quantize`` and the cohort entry's ``plan_quantize_cohort``), on the
CPU.

The plan is pure arithmetic over the shapes, the SM count, the shared
memory a block may take and the kernel's occupancy query, so it is held
here with an occupancy model of an H100 (132 SMs; 233,472 bytes of shared
memory an SM, 1,024 of them reserved per block; the kernel's 4,500 static
bytes; one block of 512 threads an SM by registers). The kernel itself is
held on the card by tests/test_torch_cuda.py.
"""
import pytest

from repro_torch.kernels.quantize import (ALIGN, MAX_INDEX, CohortPlan,
                                          QuantizePlan, plan_quantize,
                                          plan_quantize_cohort)

SMS, SM_SMEM, RESERVED, STATIC = 132, 233_472, 1_024, 4_500
MAX_SMEM = 232_448 - STATIC


def h100_blocks_per_sm(resident, smem):
    return min(1, SM_SMEM // (smem + STATIC + RESERVED))


def plan(n, d):
    return plan_quantize(n, d, SMS, MAX_SMEM, h100_blocks_per_sm)


def test_main_path_payload_is_resident_one_block_an_sm():
    # 100 slots x D = 16384 f32 (6.5 MB): a span of 12,416 elements a block
    assert plan(100, 16384) == QuantizePlan(grid=132, span=12416,
                                            smem_bytes=49664, resident=True)


def test_payload_past_one_waves_shared_memory_takes_the_l2_route():
    # 2000 x 16384 f32 is 131 MB, past 132 x 227 KB
    p = plan(2000, 16384)
    assert not p.resident and p.smem_bytes == 0 and p.grid == SMS
    assert p.span * p.grid >= 2000 * 16384
    # the last payload that still fits, and the next row past it
    fits = MAX_SMEM // 4 // ALIGN * ALIGN * SMS // 16384
    assert plan(fits, 16384).resident
    assert not plan(fits + 1, 16384).resident


def test_the_l2_route_keeps_the_resident_plans_grid_and_spans():
    # with no shared memory to stage in, the same payload takes the same
    # wave and spans on the L2 route (what the card tests launch to hold
    # the two routes to the same bytes)
    res = plan(100, 16384)
    l2 = plan_quantize(100, 16384, SMS, MAX_SMEM,
                       lambda resident, smem: 0 if resident else 1)
    assert l2 == res._replace(smem_bytes=0, resident=False)


def test_no_block_fits_raises():
    with pytest.raises(RuntimeError):
        plan_quantize(2000, 16384, SMS, MAX_SMEM, lambda res, smem: 0)


def test_a_payload_past_32_bit_indices_is_refused():
    with pytest.raises(ValueError):
        plan(MAX_INDEX // 16384 + 1, 16384)


@pytest.mark.parametrize("n,d", [(1, 1), (1, 16384), (6, 10), (37, 1001),
                                 (100, 16384), (64, 300), (1037, 61),
                                 (0, 200), (20, 0)])
def test_spans_cover_the_payload_in_whole_stores(n, d):
    p = plan(n, d)
    assert p.span % ALIGN == 0
    assert p.span * p.grid >= n * d
    assert p.span * p.grid - n * d < ALIGN * p.grid   # no idle wave
    assert p.resident
    assert p.smem_bytes == 4 * p.span <= MAX_SMEM
    assert h100_blocks_per_sm(True, p.smem_bytes) >= 1


def cohort(b, n, d):
    return plan_quantize_cohort(b, n, d, SMS, MAX_SMEM, h100_blocks_per_sm)


def test_cohort_of_one_is_the_single_plan():
    single = plan(100, 16384)
    assert cohort(1, 100, 16384) == CohortPlan(
        per_client=SMS, grid=single.grid, span=single.span,
        smem_bytes=single.smem_bytes, resident=True)


def test_main_path_cohort_splits_the_wave_among_the_clients():
    # 4 clients x 100 slots x D = 16384: 33 blocks a client, one wave,
    # each span staged in shared memory
    p = cohort(4, 100, 16384)
    assert p == CohortPlan(per_client=33, grid=132, span=49664,
                           smem_bytes=4 * 49664, resident=True)
    assert p.span * p.per_client >= 100 * 16384


@pytest.mark.parametrize("b", [133, 200, 1000])
def test_more_clients_than_sms_take_the_l2_route(b):
    # a block takes several clients' virtual blocks: nothing is staged
    p = cohort(b, 100, 64)
    assert p.per_client == 1 and p.grid == SMS
    assert not p.resident and p.smem_bytes == 0
    assert p.span == 100 * 64


@pytest.mark.parametrize("b,n,d", [(2, 100, 16384), (5, 37, 1001),
                                   (132, 100, 64), (3, 0, 200), (7, 20, 0),
                                   (4, 1, 1)])
def test_cohort_spans_cover_each_client_in_whole_stores(b, n, d):
    # every client, whatever its mask (all rows masked included: the kernel
    # then takes the same spans of the masked elements), is covered by its
    # virtual blocks' spans in whole 16-element stores
    p = cohort(b, n, d)
    assert p.grid == min(b * p.per_client, SMS) <= SMS
    assert p.span % ALIGN == 0
    assert p.span * p.per_client >= n * d
    assert p.span * p.per_client - n * d < ALIGN * p.per_client
    assert p.resident and p.smem_bytes == 4 * p.span <= MAX_SMEM


def test_a_cohort_past_32_bit_indices_is_refused():
    with pytest.raises(ValueError):
        cohort(4, MAX_INDEX // (4 * 16384) + 1, 16384)
    cohort(4, 100, 16384)


def test_no_cohort_block_fits_raises():
    with pytest.raises(RuntimeError):
        plan_quantize_cohort(200, 100, 64, SMS, MAX_SMEM, lambda r, s: 0)
