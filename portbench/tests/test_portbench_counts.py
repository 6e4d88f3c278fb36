"""The frozen counts against shapes worked by hand."""

import math

import pytest

from portbench import counts, harness

PHI = harness.load_json(harness.ROOT / "portbench/configs/phi35moe-16of32.json")
MAMBA = harness.load_json(harness.ROOT / "portbench/configs/falconmamba7b-16of64.json")


def test_phi_prefill_flops_by_hand():
    L = 1024
    d, h, kv, hd, f, e = 4096, 32, 8, 128, 6400, 16
    proj = 2 * L * d * (h + 2 * kv) * hd + 2 * L * h * hd * d
    core = 4 * h * hd * L * (L + 1) / 2
    moe = 2 * L * d * e + 6 * L * 2 * d * f
    want = 16 * (proj + core + moe) + 2 * d * 32064
    assert counts.prefill_flops(PHI, L) == pytest.approx(want, rel=1e-12)
    # about 6.4 GFLOP a token at 1024: experts at top-2, not at capacity
    assert 6.0e9 < counts.prefill_flops(PHI, L) / L < 6.8e9


def test_mamba_flops_by_hand():
    L = 4096
    d, di, st, r = 4096, 8192, 16, 256
    layer = 2 * L * (d * 2 * di + di * (r + 2 * st) + r * di + di * d) + 2 * L * di * 4 + 6 * L * di * st
    assert counts.prefill_flops(MAMBA, L) == pytest.approx(16 * layer + 2 * d * 65024)
    assert counts.train_flops(MAMBA, 1, L) == pytest.approx(3 * (16 * layer + 2 * L * d * 65024))


def test_k9_bytes_match_the_kernel_table():
    """PERF.md's table: K9 at (1, 32768, 8192, 16) has a byte bound of 0.641901 ms and an SFU floor of 1.027072 ms."""
    c = counts.k9_counts(1, 32768, 8192, 16)
    assert c["bytes"] / counts.PEAKS["hbm_bytes"] * 1e3 == pytest.approx(0.641901, abs=1e-6)
    assert c["exp"] / counts.PEAKS["sfu_exp"] * 1e3 == pytest.approx(1.027072, abs=1e-6)
    assert counts.bound_s(c) == c["exp"] / counts.PEAKS["sfu_exp"]


def test_k10_bytes_by_hand():
    n, d, st, chunk = 4096, 8192, 16, 32
    inputs = 4 * n * d + 2 * n * d + 2 * 2 * n * st + 2 * d * st + 4 * (n // chunk) * d * st + 4 * d * st + 2 * n * d
    outputs = 4 * (2 * n * d + 2 * n * st + d * st)
    c = counts.k10_counts(1, n, d, st, chunk)
    assert c["bytes"] == inputs + outputs
    assert c["exp"] / counts.PEAKS["sfu_exp"] * 1e3 == pytest.approx(0.128384, abs=1e-6)


def test_sort_bytes():
    assert counts.kv_sort_bytes(32768) == 32768 * 16  # int32 keys and values, in and out
    assert counts.kv_sort_bytes(32768) / counts.PEAKS["hbm_bytes"] * 1e3 == pytest.approx(0.000157, abs=1e-6)
    assert counts.topk_bytes(32064, 40, 2) == 32064 * 2 + 40 * 6


@pytest.mark.parametrize("name,kind", [
    ("void sort_tiles_kernel<int, true>(int const*, unsigned int const*)", "S1"),
    ("void sort_round_seg_kernel<int, true>(int const*, unsigned int const*)", "K3/K4"),
    ("void ssm_scan_kernel<16, false>(CUtensorMap)", "K9"),
    ("void ssm_scan_bwd_kernel<16>(CUtensorMap)", "K10"),
    ("ssm_scan_bwd_reduce(float const*)", "K10"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matrix products"),
    ("void at::native::elementwise_kernel<128, 2>", "elementwise"),
    ("Memcpy DtoH (Device -> Pinned)", "copies"),
    ("something_else", "other"),
])
def test_kind_of(name, kind):
    assert counts.kind_of(name) == kind


def test_k4_is_the_template_with_values():
    assert counts.is_k4("void sort_round_seg_kernel<int, true>(int const*)")
    assert not counts.is_k4("void sort_round_seg_kernel<int, false>(int const*)")
    assert not counts.is_k4("void sort_tiles_kernel<int, true>(int const*)")


def test_peaks():
    assert counts.PEAKS["bf16_flops"] == 989e12 and counts.PEAKS["hbm_bytes"] == 3.35e12
    assert counts.PEAKS["sfu_exp"] == pytest.approx(16 * 132 * 1.98e9)
    assert math.isclose(counts.PEAKS["fp32_flops"], 67e12)
