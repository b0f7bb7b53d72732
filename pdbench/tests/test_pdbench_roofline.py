"""The frozen formulas reproduce PERF.md's kernel-table bounds at
chip_smoke.py's phase-2 shapes."""
import pytest

from pdbench import roofline

GRANITE = {"num_layers": 1, "d_model": 4096, "num_heads": 32,
           "num_kv_heads": 8, "head_dim": 128, "d_ff": 12800,
           "vocab_size": 49155}


def test_paged_attention_bytes_at_the_phase_2_shape():
    # lens [480,200,1,0,333,16,17,256], B = 8, a 32-entry table a row
    lens = [480, 200, 1, 0, 333, 16, 17, 256]
    nbytes = roofline.paged_attention_bytes(GRANITE, lens, 8 * 32)
    assert nbytes == (2 * 8 * 4096 + sum(lens) * 2048) * 4 + 8 * 32 * 4 \
        + 8 * 4
    assert round(roofline.bound_s(0.0, nbytes) * 1e3, 5) == 0.00326


def test_flash_prefill_operations_at_the_phase_2_shape():
    # causal, q_valid [480, 300], 32 query heads of 128: PERF.md's
    # 0.0393 ms at 67 TFLOP/s (f32 on the CUDA cores)
    flops = sum(roofline.attention_flops(GRANITE,
                                         roofline.attention_pairs(0, n))
                for n in (480, 300))
    assert round(flops / 67e12 * 1e3, 4) == 0.0393
    assert flops / roofline.PEAK_FLOPS < flops / 67e12


def test_a_warm_suffix_pairs_each_row_with_its_prefix():
    assert roofline.attention_pairs(1024, 1) == 1025
    assert roofline.attention_pairs(0, 3) == 6
    assert roofline.attention_pairs(10, 2) == 23


def test_forward_flops_counts_routed_and_shared_experts():
    moe = dict(GRANITE, moe={"num_experts": 64, "top_k": 6,
                             "num_shared_experts": 2, "d_ff_expert": 1408})
    d, f = 4096, 1408
    attn = 2 * d * 4096 + 2 * d * 1024
    want = attn + d * 64 + 8 * 3 * d * f + d * 49155
    assert roofline.matmul_params_per_token(moe) == want
    assert roofline.forward_flops(moe, 0, 1) == pytest.approx(
        2 * want + 4 * 1 * 4096)
