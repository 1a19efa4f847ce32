"""Roofline accounting: the published-peak table keyed by device kind, the
precision-to-unit map, and the cost-model reports."""
import pytest

from ofdm_lte_tpu import LTEConfig
from ofdm_lte_tpu.utils import profiling as pr

H100_SXM = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("kind,tf32,hbm", [
    (H100_SXM, 495e12, 3.35e12),
    ("NVIDIA H100 PCIe", 378e12, 2.0e12),
])
def test_h100_kinds_resolve(kind, tf32, hbm):
    p = pr.peaks_for(kind)
    assert p["tf32"] == tf32 and p["hbm"] == hbm
    # the tensor cores' bf16 rate doubles TF32; float32 stays far below
    assert p["bf16"] > p["tf32"] > p["fp32"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "no such device"])
def test_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        pr.peaks_for(kind)


def test_precision_units():
    assert pr.PRECISION_UNIT == {"default": "tf32", "high": "tf32",
                                 "highest": "fp32"}
    assert set(pr.PRECISION_UNIT.values()) <= set(pr.PEAKS[H100_SXM])


def test_reports_carry_fractions():
    cfg = LTEConfig(bandwidth=20.0, modulation="64-QAM")
    r = pr.roofline_report(cfg, 14, 256, 1.4e-3, H100_SXM,
                           precision="default")
    assert r["device_kind"] == H100_SXM
    assert 0 < r["roofline_fraction"]
    # steady-state accounting: the TX side and (freq-AWGN) RX DFTs are
    # loop-invariant under the fixed-codeword harness and excluded from
    # the per-step fraction; the full chain stays reported separately
    assert {"tx_idft", "qam_map", "papr", "awgn_sigma", "rx_dft_data",
            "rx_dft_pilot"} <= set(r["hoisted_stages"])
    assert r["full_chain_roofline_s"] > r["roofline_s"]
    assert r["full_chain_model_over_measured_x"] > r["roofline_fraction"]
    # highest precision charges the modem matmuls at the float32 rate
    r_hi = pr.roofline_report(cfg, 14, 256, 1.4e-3, H100_SXM,
                              precision="highest")
    assert (r_hi["per_kernel_us"]["tx_idft"]
            > r["per_kernel_us"]["tx_idft"])
    rs = pr.spatial_roofline_report(cfg, 14, 1024, 15e-3, H100_SXM)
    assert 0 < rs["roofline_fraction"]
    assert rs["hoisted_stages"] == ["papr_corr", "qam_map_precode",
                                    "tx_idft"]
    assert set(rs["per_kernel_us"]) == {
        "qam_map_precode", "tx_idft", "papr_corr", "channel_bins",
        "estimate_per_tx", "detect_mmse2", "demap_count"}
    with pytest.raises(KeyError):
        pr.roofline_report(cfg, 14, 256, 1.4e-3, "cpu")


def test_fir_report_names_the_channel_fir_family():
    cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
    costs = pr.simo_frame_cost(cfg, 14, 256, num_rx=4)
    r = pr.fir_roofline_report(costs, 5.6e-3, H100_SXM)
    assert r["channel_fir_roofline_s"] > 0
    assert {"jakes_matmul", "tap_fma"} <= set(r["per_kernel_us"])
    # the FIR family dominates the modeled channel cost for this workload
    fir = r["per_kernel_us"]["jakes_matmul"] + r["per_kernel_us"]["tap_fma"]
    assert fir > 0.3 * sum(r["per_kernel_us"].values())


def test_spatial_time_impl_models_rx_dfts():
    cfg = LTEConfig(bandwidth=20.0, modulation="64-QAM")
    peaks = pr.peaks_for(H100_SXM)
    c_bins = pr.spatial_frame_cost(cfg, 14, 256, channel_impl="bins")
    c_time = pr.spatial_frame_cost(cfg, 14, 256, channel_impl="time")
    assert "rx_dft" in c_time and "rx_dft" not in c_bins
    t_bins = sum(c.roofline_time_s(peaks) for c in c_bins.values())
    t_time = sum(c.roofline_time_s(peaks) for c in c_time.values())
    assert t_time > t_bins   # the bin identity removes modeled work
