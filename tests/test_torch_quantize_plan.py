"""The int8 quantize kernel's launch plan (``kernels/quantize.py``
``plan_quantize``), on the CPU.

The plan is pure arithmetic over the shapes, the SM count, the shared
memory a block may take and the kernel's occupancy query, so it is held
here with an occupancy model of an H100 (132 SMs; 233,472 bytes of shared
memory an SM, 1,024 of them reserved per block; the kernel's 4,500 static
bytes; one block of 512 threads an SM by registers). The kernel itself is
held on the card by tests/test_torch_cuda.py.
"""
import pytest

from repro_torch.kernels.quantize import (ALIGN, MAX_INDEX, QuantizePlan,
                                          plan_quantize)

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
