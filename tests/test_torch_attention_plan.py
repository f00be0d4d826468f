"""The host-side planning of the port's attention kernels, on the CPU.

* ``decode_attention.plan_splits``: the split of S across blocks that the
  flash-decode kernel runs (``csrc/decode_attention.cu``) covers every
  slot exactly once, in order, in whole block tiles, with at least one
  split, no empty split and never more splits than tiles;
* ``flash_attention.prefill_route``: bf16 with D % 16 == 0 and D <= 256
  (and 16-byte aligned data) takes the tensor-core kernel, the rest the
  CUDA-core kernel;
* ``flash_attention.bwd_route``: the backward's tensor-core kernels take
  bf16 with D % 16 == 0, D <= 128, at most 64 query heads a kv head and
  16-byte aligned data; the rest (f32, D 72, D 256) the CUDA-core ones;
  ``reset_launch_counts`` zeroes both wrappers' counts by route;
* both modules import, and the wrappers run their plain versions, without
  CUDA.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

H100_SMS = 132


def _ranges(s, splits, per):
    return [(z * per, min(s, (z + 1) * per)) for z in range(splits)]


@pytest.mark.parametrize("bkv", [1, 8, 256])
@pytest.mark.parametrize("s", [1, 300, 1000, 32768, 524288])
def test_decode_split_plan_covers_every_slot_once_in_order(s, bkv):
    for d in (64, 128, 256):
        splits, per = da.plan_splits(s, bkv, H100_SMS, d)
        tile = da.tile_slots(d)
        tiles = -(-s // tile)
        assert 1 <= splits <= tiles
        assert per % tile == 0 and per > 0
        rs = _ranges(s, splits, per)
        assert rs[0][0] == 0 and rs[-1][1] == s
        assert all(lo < hi for lo, hi in rs)                # none empty
        assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))  # in order
        assert sum(hi - lo for lo, hi in rs) == s


@pytest.mark.parametrize("s,bkv,want", [
    (32768, 256, 6),      # the serve shape: B=32, KV=8 (about two waves)
    (32768, 8, 171),      # long context at B=1: many splits
    (64, 256, 1),         # one tile: one split, no combine launch
    (128, 32, 2)])        # two tiles, few rows: two splits
def test_decode_split_plan_at_the_card_shapes(s, bkv, want):
    splits, per = da.plan_splits(s, bkv, H100_SMS, 64)
    assert splits == want
    # at least two full waves of resident blocks, where S has the tiles
    waves = da.WAVES * da.RESIDENT_BLOCKS * H100_SMS
    assert splits * bkv >= waves or splits == -(-s // da.tile_slots(64))


def test_decode_split_plan_refuses_empty_shapes():
    for args in [(0, 8, 132, 64), (100, 0, 132, 64), (100, 8, 0, 64)]:
        with pytest.raises(ValueError):
            da.plan_splits(*args)


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (torch.bfloat16, 64, True, "tensor_core"),
    (torch.bfloat16, 16, True, "tensor_core"),
    (torch.bfloat16, 96, True, "tensor_core"),
    (torch.bfloat16, 128, True, "tensor_core"),
    (torch.bfloat16, 256, True, "tensor_core"),
    (torch.bfloat16, 72, True, "cuda_core"),     # not a multiple of 16
    (torch.bfloat16, 100, True, "cuda_core"),
    (torch.bfloat16, 64, False, "cuda_core"),    # no TMA without alignment
    (torch.float32, 64, True, "cuda_core"),      # f32 stays off TF32
    (torch.float32, 256, True, "cuda_core")])
def test_prefill_route_by_dtype_and_head_dim(dtype, d, aligned, want):
    assert fa.prefill_route(dtype, d, aligned) == want


@pytest.mark.parametrize("dtype,d,aligned,group,want", [
    (torch.bfloat16, 16, True, 1, "tensor_core"),
    (torch.bfloat16, 64, True, 4, "tensor_core"),     # llama3.2-1b
    (torch.bfloat16, 64, True, 7, "tensor_core"),     # qwen2-0.5b
    (torch.bfloat16, 96, True, 1, "tensor_core"),     # padded to 128
    (torch.bfloat16, 128, True, 4, "tensor_core"),    # phi3
    (torch.bfloat16, 64, True, 64, "tensor_core"),    # one query a tile
    (torch.bfloat16, 256, True, 2, "cuda_core"),      # dK, dV: no room
    (torch.bfloat16, 72, True, 1, "cuda_core"),       # not a multiple of 16
    (torch.bfloat16, 144, True, 1, "cuda_core"),
    (torch.bfloat16, 64, True, 65, "cuda_core"),      # no whole query a tile
    (torch.bfloat16, 64, False, 4, "cuda_core"),      # no TMA unaligned
    (torch.float32, 64, True, 4, "cuda_core"),        # f32 stays off TF32
    (torch.float32, 128, True, 1, "cuda_core")])
def test_bwd_route_by_dtype_head_dim_and_group(dtype, d, aligned, group,
                                               want):
    assert fa.bwd_route(dtype, d, aligned, group) == want


def test_bwd_route_reads_the_group_and_the_pointers_alignment():
    q = torch.zeros(1, 8, 14, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    assert fa.bwd_route_for(q, k, k, q, q) == "tensor_core"
    assert fa.bwd_route_for(q.float(), k.float(), k.float(), q.float(),
                            q.float()) == "cuda_core"
    flat = torch.zeros(1 + q.numel(), dtype=torch.bfloat16)
    off = flat[1:].view(q.shape)
    assert fa.bwd_route_for(q, k, k, q, off) == "cuda_core"
    wide = torch.zeros(1, 8, 130, 64, dtype=torch.bfloat16)
    assert fa.bwd_route_for(wide, k, k, wide, wide) == "cuda_core"


def test_prefill_route_reads_the_pointers_alignment():
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    assert fa.route_for(q, k, k) == "tensor_core"
    # a contiguous view 2 bytes into its storage is not 16-byte aligned
    flat = torch.zeros(1 + 8 * 2 * 64, dtype=torch.bfloat16)
    off = flat[1:].view(1, 8, 2, 64)
    assert off.is_contiguous() and fa.route_for(q, off, k) == "cuda_core"


def test_tile_slots_follow_the_kernel_tiling():
    # NW warps x NPASS passes x 256 / DMAX slots a pass
    assert [da.tile_slots(d) for d in (1, 64, 65, 128, 129, 256)] == \
        [64, 64, 32, 32, 16, 16]


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    r = np.random.default_rng(0)
    q = torch.from_numpy(r.normal(size=(1, 40, 14, 64)).astype(np.float32))
    k = torch.from_numpy(r.normal(size=(1, 40, 2, 64)).astype(np.float32))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, k, causal=True)
    assert torch.equal(got, ref.flash_attention_ref(q, k, k, causal=True))
    valid = torch.ones(1, 40, dtype=torch.bool)
    got = ops.flash_decode(q[:, :1], k, k, valid)
    assert torch.equal(got, ref.flash_decode_ref(q[:, :1], k, k, valid))
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.flash_attention.launches_by_route == {"tensor_core": 0,
                                                     "cuda_core": 0}
    out, lse = ops.flash_attention(q, k, k, causal=True, return_stats=True)
    ops.flash_attention_bwd.launches_by_route["tensor_core"] = 3
    ops.reset_launch_counts()
    grads = ops.flash_attention_bwd(q, k, k, out, q, lse, causal=True)
    assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
    assert ops.flash_attention_bwd.launches == 0
    assert ops.flash_attention_bwd.launches_by_route == {"tensor_core": 0,
                                                         "cuda_core": 0}


def test_ptxas_usage_reads_registers_and_spills():
    """``build.ptxas_usage`` parses the ``-Xptxas -v`` report that
    ``chip_smoke.py`` quotes for the timed instantiations."""
    from repro_torch.kernels import build
    log = ("ptxas info    : Compiling entry function '_Zk1' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Zk1\n"
           "    16 bytes stack frame, 12 bytes spill stores, "
           "16 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Zk2' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Zk2\n"
           "    0 bytes stack frame, 0 bytes spill stores, "
           "0 bytes spill loads\n"
           "ptxas info    : Used 40 registers, used 0 barriers\n")
    assert build.ptxas_usage(log) == {
        "_Zk1": {"registers": 168, "stack_frame": 16, "spill_stores": 12,
                 "spill_loads": 16},
        "_Zk2": {"registers": 40, "stack_frame": 0, "spill_stores": 0,
                 "spill_loads": 0}}
