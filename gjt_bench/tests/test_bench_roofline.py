"""The work and byte counts of B1 and B2 against the bounds the port's
PERF.md states for them (B1 at 2048 lags 0.0115 ms by operations; B2 at
nperseg 1024 over 512k samples 0.0013 ms by bytes), at the data sheet's
peaks."""
import pytest

from gjt_bench import roofline

H100 = "NVIDIA H100 80GB HBM3"


def test_b1_bound_at_2048_lags():
    t, by = roofline.least_seconds(*roofline.pcf_search(2048, 32, 15),
                                   roofline.peaks(H100))
    assert by == "operations"
    assert round(t * 1e3, 4) == 0.0115


def test_b2_bound_at_nperseg_1024():
    t, by = roofline.least_seconds(*roofline.welch_psd(1 << 19, 1024),
                                   roofline.peaks(H100))
    assert by == "bytes"
    assert round(t * 1e3, 4) == 0.0013


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_fft_count_is_5_n_log2_n(n):
    import math
    assert roofline.fft_ops(n) == 5 * n * math.log2(n)


def test_unknown_card_has_no_peaks():
    assert roofline.peaks("some other card") is None
