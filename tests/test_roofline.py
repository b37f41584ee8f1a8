"""utils/roofline: one peaks row per device kind; unknown kinds are errors."""

from types import SimpleNamespace

import pytest

from ppcseq.utils.roofline import peaks_for, utilization

H100 = SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")


def test_h100_row_and_shares():
    p = peaks_for(H100)
    assert p == {"hbm_bytes_per_sec": 3.35e12, "f32_flops": 67e12, "bf16_flops": 989e12}
    u = utilization(6.7e12, 1.675e12, H100)
    assert u["f32_peak_frac"] == pytest.approx(0.1)
    assert u["hbm_peak_frac"] == pytest.approx(0.5)
    assert "f32 peak" in u["utilization_note"] and "HBM peak" in u["utilization_note"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_is_an_error(kind):
    dev = SimpleNamespace(device_kind=kind)
    with pytest.raises(KeyError, match="no roofline peaks"):
        peaks_for(dev)
    with pytest.raises(KeyError):
        utilization(1e12, 1e11, dev)
