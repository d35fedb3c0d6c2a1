"""The frozen work functions, worked by hand at a small shape."""

import pytest

from gpbench import opcount as oc


def test_single_evidence_by_hand():
    # B = 2 spectra, S = 3 samples, P = 4 pixels, k = 2, 1 line, 3 taps, no window
    w = oc.evidence_single(B=2, S=3, P=4, k=2, num_lines=1, taps=3, window=None)
    P6 = 6
    per_sample_fp32 = (P6 * 1 * 8 + P6 * 1 * 6 + P6 * 2          # profile, core, exp
                       + 4 * (2 * 3 + 12) + 2**3 / 3 + 2 * 2 * 2)  # conv + weights, Cholesky
    per_sample_matrix = 4 * (2 * 3 + 2 * 2)                        # Gram k(k+1)/2 + proj k, x2
    assert w.fp32 == pytest.approx(6 * per_sample_fp32)
    assert w.matrix == pytest.approx(6 * per_sample_matrix)
    # inputs once: ext (P6), flux, mu, omega2, noise, mask (5P), M (Pk); z, nhi in, out
    assert w.bytes == 4.0 * 2 * (6 + 5 * 4 + 4 * 2 + 3 * 3)


def test_window_counts_the_core_inside_it_only():
    full = oc.evidence_single(1, 1, 100, 2, 3, 7, None)
    win = oc.evidence_single(1, 1, 100, 2, 3, 7, 10)
    assert full.fp32 - win.fp32 == pytest.approx((106 - 10) * 3 * oc.CORE_FLOPS)


def test_pair_counts_the_base_axis_once_per_draw():
    single = oc.evidence_single(1, 8, 4, 1, 1, 3, None)
    pair = oc.evidence_pair(1, 8, 4, 1, 1, 3, None, base_draws=2)
    extra = 2 * 6 * 1 * (oc.PROFILE_FLOPS + oc.CORE_FLOPS) + 8 * 6
    assert pair.fp32 - single.fp32 == pytest.approx(extra)
    assert pair.bytes - single.bytes == pytest.approx(8 * 8)


def test_base_draws_of_the_replicated_layout():
    assert oc.base_draws(256, 4) == 64
    assert oc.base_draws(10000, 4) == 2512
    assert oc.base_draws(10000, 1) == 10000


def test_least_time_is_the_widest_pipe():
    w = oc.Work(fp32=67e12, matrix=495e12 * 2, bytes=3.35e12 * 0.5)
    assert w.least_seconds() == pytest.approx(2.0)
    assert (w + w).least_seconds() == pytest.approx(4.0)
    assert (w * 3).least_seconds() == pytest.approx(6.0)


def test_sample_window_of_evenly_spread_samples():
    import numpy as np

    off = np.linspace(0, 1, 1000)
    W = oc.sample_window(off, 1280, 3, 1e-4)
    spread = off[255] - off[0]
    expect = int(np.ceil(max(spread * 1280, np.log10(1 + spread * (1215.6701 / 911.7633 - 1)) / 1e-4))) + 80
    assert W == -(-expect // 8) * 8
