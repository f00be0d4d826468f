"""``kernels/cost.py`` against the bound column of ``PERF.md`` §6: each
kernel row's least time on the H100 (the larger of its bytes over the HBM
rate and its FLOPs over the peak of its type, ``launch/mesh.py``) at the
row's shape as ``chip_smoke.py`` names it. Level: 1e-9 relative — the
same arithmetic, so the bound column does not move when ``chip_smoke.py``
reads this module instead of its inline counts."""
import pytest
import torch

from repro_torch.kernels import cost
from repro_torch.launch.mesh import (H100_HBM_BW, H100_PEAK_FLOPS_BF16,
                                     H100_PEAK_FLOPS_F32)


def bound_ms(kc, peak):
    t_mem, t_ops = kc.hbm_bytes / H100_HBM_BW, kc.flops / peak
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


F32, BF16 = H100_PEAK_FLOPS_F32, H100_PEAK_FLOPS_BF16

# (the row of PERF.md §6, its KernelCost at chip_smoke.py's shape, the
# peak of its type, the bound column's ms and "by")
ROWS = [
    ("kmeans_pairwise_dist: a client's 2,500 x 200 features, 10 centres",
     cost.kmeans_pairwise_dist(2500, 200, 10), F32,
     0.0006292537313432835, "bytes"),
    ("kmeans_lloyd_step: 2,500 x 200, 100 slots, every row admissible",
     cost.kmeans_lloyd_step(2500, 200, 100, admissible_rows=2500), F32,
     0.0015304477611940298, "operations"),
    ("quantize_affine: 100 x 16,384, 20 of 100 rows valid",
     cost.quantize_affine(100, 16384, 20), F32,
     0.0008803665671641792, "bytes"),
    ("quantize_affine: 100 x 16,384, 80 of 100 rows valid",
     cost.quantize_affine(100, 16384, 80), F32,
     0.002054145671641791, "bytes"),
    ("quantize_affine_batched: 4 x 100 x 16,384, 20 valid each",
     cost.quantize_affine_batched(4, 100, 16384, 4 * 20), F32,
     0.0035214662686567167, "bytes"),
    ("flash_attention: B 1, S 32,768, 32 / 8 heads, D 64, causal",
     cost.flash_attention(1, 32768, 32, 8, 64), BF16,
     4.446963105261881, "operations"),
    ("flash_attention_enc: B 16, S 1,500, 16 / 16, D 64, non-causal",
     cost.flash_attention(16, 1500, 16, 16, 64, causal=False), BF16,
     0.14909605662285136, "operations"),
    ("flash_attention_g1: B 1, S 32,768, 16 / 16, D 64, causal",
     cost.flash_attention(1, 32768, 16, 16, 64), BF16,
     2.2234815526309406, "operations"),
    ("flash_attention_cross: 32,768 queries over Sk 1,500, 16 / 16, D 64",
     cost.flash_attention(1, 32768, 16, 16, 64, sk=1500, causal=False),
     BF16, 0.20356581597573306, "operations"),
    ("flash_attention_d128: B 1, S 32,768, 32 / 4, D 128, causal",
     cost.flash_attention(1, 32768, 32, 4, 128), BF16,
     8.893926210523762, "operations"),
    ("flash_attention_d128_g6: B 1, S 32,768, 48 / 8, D 128, causal",
     cost.flash_attention(1, 32768, 48, 8, 128), BF16,
     13.340889315785642, "operations"),
    ("flash_attention_d192: B 1, S 32,768, 128 / 128, D 192, causal",
     cost.flash_attention(1, 32768, 128, 128, 192), BF16,
     53.36355726314257, "operations"),
    ("flash_decode: B 32, 32,768 slots, 32 / 8, D 64",
     cost.flash_decode(32, 32768, 32, 8, 64), BF16,
     0.6414311546268657, "bytes"),
    ("flash_decode_g1: B 16, 32,768 slots, 16 / 16, D 64",
     cost.flash_decode(16, 32768, 16, 16, 64), BF16,
     0.6412159617910448, "bytes"),
    ("flash_decode_cross: B 16, 1,500 slots, 16 / 16, D 64",
     cost.flash_decode(16, 1500, 16, 16, 64), BF16,
     0.029371204776119403, "bytes"),
    ("flash_decode_d128: B 4, 32,768 slots, 32 / 4, D 128",
     cost.flash_decode(4, 32768, 32, 4, 128), BF16,
     0.08018867582089553, "bytes"),
    ("flash_decode_d128_g6: B 4, 32,768 slots, 48 / 8, D 128",
     cost.flash_decode(4, 32768, 48, 8, 128), BF16,
     0.16032844417910447, "bytes"),
    ("flash_decode_d192: B 4, 32,768 slots, 128 / 128, D 192",
     cost.flash_decode(4, 32768, 128, 128, 192), BF16,
     3.846395873432836, "bytes"),
    ("flash_attention_bwd: B 4, S 4,096, 32 / 8, D 64, causal",
     cost.flash_attention_bwd(4, 4096, 32, 8, 64), BF16,
     0.6950076233771486, "operations"),
    ("flash_attention_bwd_cross: B 4, S 4,096, Sk 1,500, 16 / 16, D 64",
     cost.flash_attention_bwd(4, 4096, 16, 16, 64, sk=1500, causal=False),
     BF16, 0.25445726996966633, "operations"),
    ("flash_attention_bwd_cross at whisper's own S 448",
     cost.flash_attention_bwd(4, 448, 16, 16, 64, sk=1500, causal=False),
     BF16, 0.027831263902932255, "operations"),
    ("flash_attention_bwd_enc: B 4, S = Sk = 1,500, 16 / 16, D 64",
     cost.flash_attention_bwd(4, 1500, 16, 16, 64, causal=False), BF16,
     0.0931850353892821, "operations"),
    ("flash_attention_bwd_d128_g6: B 4, S 4,352, 48 / 8, D 128, causal",
     cost.flash_attention_bwd(4, 4352, 48, 8, 128), BF16,
     2.35376155437816, "operations"),
]


@pytest.mark.parametrize("row,kc,peak,want_ms,want_by", ROWS,
                         ids=[r[0].split(":")[0] + f"[{i}]"
                              for i, r in enumerate(ROWS)])
def test_cost_reproduces_the_bound_column(row, kc, peak, want_ms, want_by):
    got_ms, got_by = bound_ms(kc, peak)
    assert got_ms == pytest.approx(want_ms, rel=1e-9), row
    assert got_by == want_by, row


def test_a_window_counts_the_pairs_it_keeps():
    """Level: exact — a causal window of W over S keeps W (W + 1) / 2 +
    (S - W) W pairs, a non-causal one every key at or after qi - W + 1;
    with no window, the forward's causal rule is half of S x S and the
    backward's the S (S + 1) / 2 of the lower triangle."""
    s, w, b, h, d = 100, 10, 1, 1, 1
    kept = w * (w + 1) // 2 + (s - w) * w
    assert cost.flash_attention(b, s, h, h, d, window=w).flops == 4 * kept
    assert cost.flash_attention_bwd(b, s, h, h, d, window=w).flops \
        == 10 * kept
    non_causal = sum(s - max(0, i - w + 1) for i in range(s))
    assert cost.flash_attention(b, s, h, h, d, causal=False,
                                window=w).flops == 4 * non_causal
    assert cost.flash_attention(b, s, h, h, d).flops == 4 * s * s / 2
    assert cost.flash_attention_bwd(b, s, h, h, d).flops \
        == 10 * s * (s + 1) // 2


def test_dtypes_and_statistics_count_their_bytes():
    """Level: exact — f32 doubles the tensors' bytes, the statistics add
    (B, H, S) f32, an f32 cache under a bf16 query reads 4 bytes a slot
    element."""
    bf = cost.flash_attention(2, 8, 4, 2, 16)
    f32 = cost.flash_attention(2, 8, 4, 2, 16, dtype=torch.float32)
    stats = cost.flash_attention(2, 8, 4, 2, 16, return_stats=True)
    assert f32.hbm_bytes == 2 * bf.hbm_bytes
    assert stats.hbm_bytes == bf.hbm_bytes + 4 * 2 * 4 * 8
    dec = cost.flash_decode(2, 8, 4, 2, 16, cache_dtype=torch.float32)
    assert dec.hbm_bytes == 2 * 2 * 2 * 4 * 16 + 4 * 2 * 2 * 8 * 2 * 16 \
        + 2 * 8
