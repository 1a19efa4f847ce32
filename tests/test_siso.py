"""End-to-end SISO pipeline: round trips, BER anchors, PAPR, channels.

BER anchors from the reference docs: ~1% BER at SNR 6/10/16 dB for
QPSK/16-QAM/64-QAM in AWGN (README.md:949-955); SC-FDM PAPR 3-6 dB below
OFDM (README.md:938-945).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_lte_tpu import LTEConfig
from ofdm_lte_tpu.sim import siso


def run(cfg, snr, n_sym=28, seed=0, **kw):
    rng = np.random.default_rng(seed)
    mode = kw.get("mode", "lte")
    bits = rng.integers(0, 2,
                        siso.bits_per_frame(cfg, n_sym, mode)).astype(np.int32)
    return bits, siso.simulate_siso(jax.random.PRNGKey(seed), jnp.asarray(bits),
                                    snr, cfg, **kw)


@pytest.mark.parametrize("mod", ["QPSK", "16-QAM", "64-QAM"])
def test_high_snr_zero_ber(mod):
    cfg = LTEConfig(bandwidth=5.0, modulation=mod)
    _, r = run(cfg, 60.0, n_sym=14)
    assert float(r.ber) == 0.0


def test_sc_fdm_roundtrip():
    cfg = LTEConfig(bandwidth=5.0, modulation="16-QAM")
    _, r = run(cfg, 60.0, n_sym=14, mode="sc-fdm")
    assert float(r.ber) == 0.0


def test_simple_mode_roundtrip():
    cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
    _, r = run(cfg, 60.0, n_sym=7, mode="simple", enable_equalization=False)
    assert float(r.ber) == 0.0


@pytest.mark.parametrize("mod,snr,lo,hi", [
    # bounds around BER measured on the reference implementation itself
    # (simulate_siso, 5 MHz, 28 OFDM symbols): QPSK@6 0.0133, 16-QAM@10
    # 0.0600, 16-QAM@14 0.0081, 64-QAM@16 0.0624, 64-QAM@20 0.0098.
    ("QPSK", 6.0, 0.006, 0.030),
    ("16-QAM", 10.0, 0.035, 0.095),
    ("16-QAM", 14.0, 0.004, 0.018),
    ("64-QAM", 16.0, 0.035, 0.095),
    ("64-QAM", 20.0, 0.004, 0.020),
])
def test_awgn_ber_anchor(mod, snr, lo, hi):
    """BER within Monte-Carlo confidence bounds of the reference's own
    measured curve (and near the README.md:949-955 theory anchors)."""
    cfg = LTEConfig(bandwidth=5.0, modulation=mod)
    errors = total = 0
    for t in range(3):
        bits, r = run(cfg, snr, n_sym=28, seed=t)
        errors += int(r.bit_errors)
        total += len(bits)
    ber = errors / total
    assert lo < ber < hi, ber


def test_ber_monotone_in_snr():
    cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
    bers = []
    for snr in [0.0, 4.0, 8.0]:
        errors = total = 0
        for t in range(2):
            bits, r = run(cfg, snr, n_sym=28, seed=t)
            errors += int(r.bit_errors)
            total += len(bits)
        bers.append(errors / total)
    assert bers[0] > bers[1] > bers[2]


def test_scfdm_papr_lower_than_ofdm():
    """SC-FDM reduces per-symbol PAPR (README.md:938-945). Note the
    whole-stream max shows almost no delta even in the reference (9.56 vs
    9.37 dB measured on /root/reference simulate_siso) because CRS pilots
    stay un-precoded; the reduction appears in the per-symbol statistics
    (ofdm_system.py:648-736 collects CCDFs the same way)."""
    from ofdm_lte_tpu.ops import ofdm as ofdm_ops

    cfg = LTEConfig(bandwidth=5.0, modulation="16-QAM")
    rng = np.random.default_rng(0)
    means = {}
    for mode in ["lte", "sc-fdm"]:
        bits = rng.integers(0, 2,
                            siso.bits_per_frame(cfg, 100, mode)).astype(np.int32)
        sig = siso.transmit(jnp.asarray(bits), cfg, mode)
        framed = ofdm_ops.frame_stream(sig, cfg)
        means[mode] = float(jnp.mean(ofdm_ops.papr_db(framed, axis=-1)))
    assert means["sc-fdm"] < means["lte"] - 0.3


def test_rayleigh_multipath_runs():
    cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
    bits, r = run(cfg, 30.0, n_sym=28, channel_type="rayleigh_mp",
                  itu_profile="Pedestrian_A", velocity_kmh=3.0)
    ber = float(r.ber)
    assert 0.0 <= ber < 0.1  # equalized slow-fading Ped-A at 30 dB is clean-ish


def test_rayleigh_worse_than_awgn():
    cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
    err_a = err_r = tot = 0
    for t in range(3):
        bits, ra = run(cfg, 8.0, n_sym=28, seed=t)
        _, rr = run(cfg, 8.0, n_sym=28, seed=t, channel_type="rayleigh_mp",
                    itu_profile="Vehicular_A")
        err_a += int(ra.bit_errors)
        err_r += int(rr.bit_errors)
        tot += len(bits)
    assert err_r > err_a


def test_batched_lanes_and_per_lane_snr():
    cfg = LTEConfig(bandwidth=1.25, modulation="QPSK")
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (4, siso.bits_per_frame(cfg, 14))).astype(np.int32)
    snrs = jnp.asarray([0.0, 5.0, 10.0, 60.0])
    r = siso.simulate_siso(jax.random.PRNGKey(0), jnp.asarray(bits), snrs, cfg)
    assert r.ber.shape == (4,)
    b = np.asarray(r.ber)
    assert b[0] > b[2] and b[3] == 0.0


def test_pilot_snr_tracks_channel_snr():
    cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
    _, r = run(cfg, 20.0, n_sym=28)
    assert abs(float(r.pilot_snr_db) - 20.0) < 3.0


def test_bits_dtype_follows_input():
    """Sims return bits_rx in the caller's bit dtype (int8 inputs keep the
    whole bit-domain path at 1 B/bit in device memory) with identical results."""
    import jax
    import jax.numpy as jnp
    from ofdm_lte_tpu import LTEConfig
    from ofdm_lte_tpu.sim import siso
    cfg = LTEConfig(bandwidth=1.25, modulation="16-QAM")
    rng = np.random.default_rng(0)
    b32 = rng.integers(0, 2, (2, siso.bits_per_frame(cfg, 14))).astype(
        np.int32)
    r32 = siso.simulate_siso(jax.random.PRNGKey(5), jnp.asarray(b32),
                             12.0, cfg)
    r8 = siso.simulate_siso(jax.random.PRNGKey(5),
                            jnp.asarray(b32.astype(np.int8)), 12.0, cfg)
    assert r8.bits_rx.dtype == jnp.int8
    assert r32.bits_rx.dtype == jnp.int32
    assert np.array_equal(np.asarray(r8.bit_errors),
                          np.asarray(r32.bit_errors))
    assert np.array_equal(np.asarray(r8.bits_rx),
                          np.asarray(r32.bits_rx).astype(np.int8))


def test_freq_noise_matches_time_noise_statistics():
    """The AWGN fast path injects noise at the received bins
    (siso._receive_awgn_freq); by DFT unitarity it must be statistically
    identical to the generic time-domain channel. Paired comparison: same
    TX signal, same per-lane keys, 16 lanes x 28 symbols of 16-QAM at
    12 dB — BERs agree within Monte-Carlo bounds and per-lane BERs
    correlate with neither path biased."""
    import jax
    import jax.numpy as jnp
    from ofdm_lte_tpu.sim import siso
    from ofdm_lte_tpu.channel.awgn import awgn

    cfg = LTEConfig(bandwidth=5.0, modulation="16-QAM")
    rng = np.random.default_rng(3)
    lanes = 16
    bits = jnp.asarray(rng.integers(
        0, 2, (lanes, siso.bits_per_frame(cfg, 28))).astype(np.int32))
    key = jax.random.PRNGKey(9)
    snr = jnp.full((lanes,), 12.0, jnp.float32)

    r_freq = siso.simulate_siso(key, bits, snr, cfg)   # freq-noise default

    # generic time-domain path with the same keys
    sig = siso.transmit(bits, cfg, "lte")
    rx = awgn(key, sig, snr, measure_axes=-1)
    b_t, _, _ = siso.receive(rx, cfg, "lte")
    errs_t = np.asarray(jnp.sum((b_t.astype(jnp.int32) != bits)
                                .astype(jnp.int32), axis=-1))
    n = bits.shape[-1]
    ber_f = float(np.asarray(r_freq.bit_errors).sum()) / (lanes * n)
    ber_t = float(errs_t.sum()) / (lanes * n)
    # ~60k errored bits per side: 3-sigma counting bounds ~2.5% relative
    assert abs(ber_f - ber_t) < 0.15 * max(ber_f, ber_t), (ber_f, ber_t)
    assert 0.01 < ber_f < 0.05
