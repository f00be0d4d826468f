"""The host-side planning of the port's attention kernels, on the CPU.

* ``decode_attention.plan_splits``: the split of S across blocks that the
  flash-decode kernel runs (``csrc/decode_attention.cu``) covers every
  slot exactly once, in order, in whole block tiles, with at least one
  split, no empty split and never more splits than tiles;
* ``flash_attention.prefill_route``: bf16 with D % 16 == 0 and D <= 256
  (and 16-byte aligned data; MLA's D 192 too) takes the tensor-core
  kernel, the rest the CUDA-core kernel;
* ``flash_attention.bwd_route``: the backward's tensor-core kernels take
  bf16 with D % 16 == 0, D <= 128, at most 64 query heads a kv head and
  16-byte aligned data; the rest (f32, D 72, MLA's D 192, D 256) the
  CUDA-core ones; the decode plan at MLA's serve shape;
  ``reset_launch_counts`` zeroes both wrappers' counts by route;
* both modules import, and the wrappers run their plain versions, without
  CUDA;
* ``ops.flash_attention`` takes a key length Sk unlike S (whisper's
  cross-attention) without a mask, on the CPU the plain version, and
  refuses it with a mask or a gradient.
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


def test_decode_split_plan_at_mlas_decode_shape():
    """deepseek-v2-236b's naive decode at batch 4 over 32,768 slots: 512
    (batch, head) rows of D 192 (DMAX 256: 16-slot tiles, 2,048 of them)
    need 3 splits for two waves; 682 tiles a split give 4."""
    splits, per = da.plan_splits(32768, 4 * 128, H100_SMS, 192)
    assert (splits, per) == (4, 682 * 16)
    assert da.tile_slots(192) == 16
    assert splits * 4 * 128 >= da.WAVES * da.RESIDENT_BLOCKS * H100_SMS


def test_decode_split_plan_refuses_empty_shapes():
    for args in [(0, 8, 132, 64), (100, 0, 132, 64), (100, 8, 0, 64)]:
        with pytest.raises(ValueError):
            da.plan_splits(*args)


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (torch.bfloat16, 64, True, "tensor_core"),
    (torch.bfloat16, 16, True, "tensor_core"),
    (torch.bfloat16, 96, True, "tensor_core"),
    (torch.bfloat16, 128, True, "tensor_core"),
    (torch.bfloat16, 192, True, "tensor_core"),  # MLA: dn + dr = 128 + 64
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
    (torch.bfloat16, 192, True, 1, "cuda_core"),      # MLA: above 128
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


def test_launch_counts_by_lengths_key_and_reset():
    """The forward wrappers' ``launches_by_lengths``: one count a launch
    under ``"<queries>x<keys>"`` (what tells whisper's encoder, its causal
    self-attention and its cross-attention apart), zeroed by
    ``reset_launch_counts``; a plain version on the CPU counts nothing."""
    ops.reset_launch_counts()
    ops._count_lengths(ops.flash_attention, 32768, 1500)
    ops._count_lengths(ops.flash_attention, 32768, 1500)
    ops._count_lengths(ops.flash_attention, 1500, 1500)
    ops._count_lengths(ops.flash_decode, 1, 32768)
    assert ops.flash_attention.launches_by_lengths == {"32768x1500": 2,
                                                       "1500x1500": 1}
    assert ops.flash_decode.launches_by_lengths == {"1x32768": 1}
    ops.reset_launch_counts()
    q = torch.zeros(1, 3, 2, 16)
    k = torch.zeros(1, 5, 2, 16)
    ops.flash_attention(q, k, k, causal=False)
    ops.flash_decode(q[:, :1], k, k, torch.ones(1, 5, dtype=torch.bool))
    assert ops.flash_attention.launches_by_lengths == {}
    assert ops.flash_decode.launches_by_lengths == {}


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


@pytest.mark.parametrize("s,sk", [(1, 16), (12, 16), (40, 7), (7, 70),
                                  (300, 1500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_a_key_length_unlike_s_on_the_cpu(s, sk,
                                                                dtype):
    """Whisper's cross-attention: S decoder queries over Sk encoder keys
    (one query, S < Sk, S > Sk, Sk below a key tile), non-causal, no
    window. The CPU route is the plain version, which equals the
    reference's ``sdpa_full`` core (``layers.sdpa_full``) within 2e-3
    (f32) / 2e-2 (bf16); (B, H, S) statistics; no launch counted."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(s + sk)
    q = torch.randn(2, s, 4, 32, generator=g).to(dtype)
    k = torch.randn(2, sk, 2, 32, generator=g).to(dtype)
    v = torch.randn(2, sk, 2, 32, generator=g).to(dtype)
    ops.reset_launch_counts()
    got, lse = ops.flash_attention(q, k, v, causal=False,
                                   return_stats=True)
    assert got.shape == q.shape and got.dtype == dtype
    assert lse.shape == (2, 4, s) and lse.dtype == torch.float32
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    want = L.sdpa_full(q, k, v, causal=False, window=0)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)
    assert ops.flash_attention.launches == 0


def test_flash_attention_refuses_a_masked_or_differentiated_key_length():
    """Sk != S only without a mask: causal or a window raise ValueError,
    in the forward, under autograd and in ``flash_attention_bwd``; an
    empty key length is refused. (The gradient of an unmasked call at
    Sk != S is taken: the test below.)"""
    q = torch.randn(1, 8, 4, 32, generator=torch.Generator().manual_seed(0))
    k = torch.randn(1, 5, 2, 32, generator=torch.Generator().manual_seed(1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, k)]
    for kw in ({"causal": True}, {"causal": False, "window": 3}):
        for args in ((q, k, k), leaves):
            with pytest.raises(ValueError, match="causal=False"):
                ops.flash_attention(*args, **kw)
    out, lse = ops.flash_attention(q, k, k, causal=False, return_stats=True)
    for kw in ({"causal": True}, {"causal": False, "window": 3}):
        with pytest.raises(ValueError, match="causal=False"):
            ops.flash_attention_bwd(q, k, k, out, out, lse, **kw)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :0], k[:, :0], causal=False)


def test_flash_attention_takes_a_gradient_at_a_key_length_unlike_s():
    """Under autograd an unmasked call at Sk != S is taken: on the CPU it
    is the plain version differentiated by autograd, and
    ``flash_attention_bwd`` with the forward's statistics gives the same
    gradients; no launch is counted."""
    q = torch.randn(1, 8, 4, 32, generator=torch.Generator().manual_seed(0))
    k = torch.randn(1, 5, 2, 32, generator=torch.Generator().manual_seed(1))
    out, lse = ops.flash_attention(q, k, k, causal=False, return_stats=True)
    ops.reset_launch_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, k)]
    got = ops.flash_attention(*leaves, causal=False)
    dout = torch.ones(got.shape)
    grads = torch.autograd.grad(got, leaves, dout)
    want = ops.flash_attention_bwd(q, k, k, out, dout, lse, causal=False)
    assert torch.equal(got.detach(), out)
    for x, y in zip(grads, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-3,
                                   atol=2e-3)
    assert ops.flash_attention.launches == 0
    assert ops.flash_attention_bwd.launches == 0
    assert ops.flash_attention_bwd.launches_by_lengths == {}
