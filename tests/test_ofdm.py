"""Matmul-DFT OFDM modem vs NumPy FFT reference
(/root/reference/core/modulator.py:214-250, lte_receiver.py:444-491)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_lte_tpu import LTEConfig
from ofdm_lte_tpu.grid import grid_for, pilot_sequence
from ofdm_lte_tpu.ops import ofdm, scfdm
from ofdm_lte_tpu import cplx


def np_modulate(data, cfg, g):
    """Reference: grid scatter -> ifft·√N -> CP prepend."""
    pil = pilot_sequence(0, g.num_pilot)
    out = []
    for s in range(data.shape[0]):
        grid_full = np.zeros(cfg.N, complex)
        grid_full[g.data_idx] = data[s]
        grid_full[g.pilot_idx] = pil
        t = np.fft.ifft(grid_full) * np.sqrt(cfg.N)
        out.append(np.concatenate([t[-cfg.cp_length:], t]))
    return np.stack(out)


@pytest.mark.parametrize("bw", [1.25, 5.0, 20.0])
def test_modulate_matches_fft(bw, rng):
    cfg = LTEConfig(bandwidth=bw)
    g = grid_for(cfg)
    data = (rng.standard_normal((4, g.num_data))
            + 1j * rng.standard_normal((4, g.num_data)))
    got = ofdm.modulate_symbols(cplx.from_numpy(data), cfg).to_numpy()
    ref = np_modulate(data, cfg, g)
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("bw", [1.25, 5.0])
def test_demodulate_inverts_modulate(bw, rng):
    cfg = LTEConfig(bandwidth=bw)
    g = grid_for(cfg)
    data = (rng.standard_normal((3, g.num_data))
            + 1j * rng.standard_normal((3, g.num_data)))
    tx = ofdm.modulate_symbols(cplx.from_numpy(data), cfg)
    back = ofdm.demodulate_bins(tx, cfg, g.data_idx).to_numpy()
    np.testing.assert_allclose(back, data, atol=2e-3)
    # pilot bins recover the pilot sequence
    pil = ofdm.demodulate_bins(tx, cfg, g.pilot_idx).to_numpy()
    np.testing.assert_allclose(pil, np.tile(pilot_sequence(0, g.num_pilot), (3, 1)),
                               atol=2e-3)


def test_demodulate_full_matches_fft(rng):
    cfg = LTEConfig(bandwidth=1.25)
    y = rng.standard_normal((2, cfg.samples_per_ofdm_symbol)) \
        + 1j * rng.standard_normal((2, cfg.samples_per_ofdm_symbol))
    got = ofdm.demodulate_full(cplx.from_numpy(y), cfg).to_numpy()
    ref = np.fft.fft(y[:, cfg.cp_length:], axis=-1) / np.sqrt(cfg.N)
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_frame_stream():
    cfg = LTEConfig(bandwidth=1.25)
    sps = cfg.samples_per_ofdm_symbol
    sig = cplx.from_numpy(np.arange(3 * sps + 7) + 0j)
    framed = ofdm.frame_stream(sig, cfg)
    assert framed.shape == (3, sps)
    np.testing.assert_allclose(framed.to_numpy()[1],
                               np.arange(sps, 2 * sps))


def test_scfdm_unitary_roundtrip(rng):
    M = 249
    x = rng.standard_normal((5, M)) + 1j * rng.standard_normal((5, M))
    pre = scfdm.precode(cplx.from_numpy(x), M)
    ref = np.fft.fft(x, axis=-1) / np.sqrt(M)
    np.testing.assert_allclose(pre.to_numpy(), ref, atol=2e-3)
    back = scfdm.decode(pre, M)
    np.testing.assert_allclose(back.to_numpy(), x, atol=2e-3)


def test_papr():
    sig = cplx.from_numpy(np.array([1.0, 1.0, 2.0, 1.0], dtype=complex))
    papr = float(ofdm.papr_db(sig))
    p = np.abs([1, 1, 2, 1]) ** 2.0
    assert np.isclose(papr, 10 * np.log10(p.max() / p.mean()), atol=1e-5)


def test_papr_per_symbol_no_cp(rng):
    from ofdm_lte_tpu import cplx as _cplx
    cfg = LTEConfig(bandwidth=1.25)
    sps = cfg.samples_per_ofdm_symbol
    sig = _cplx.from_numpy(rng.standard_normal(3 * sps)
                           + 1j * rng.standard_normal(3 * sps))
    p_cp = ofdm.papr_per_symbol_db(sig, cfg, include_cp=True)
    p_nocp = ofdm.papr_per_symbol_db(sig, cfg, include_cp=False)
    assert p_cp.shape == p_nocp.shape == (3,)
    # no-CP window is a subset: its peak can only drop, its mean shifts;
    # both stay finite and positive for noise-like signals
    assert np.all(np.asarray(p_cp) > 0) and np.all(np.asarray(p_nocp) > 0)


def test_modem_cmatmul_backend_gauss(rng, monkeypatch):
    """End-to-end modem parity with OFDM_LTE_TPU_CMATMUL=gauss."""
    from ofdm_lte_tpu.cplx import C
    cfg = LTEConfig(bandwidth=1.25, modulation="QPSK")
    nd = grid_for(cfg).num_data
    data = C(jnp.asarray(rng.standard_normal((4, 3, nd)), jnp.float32),
             jnp.asarray(rng.standard_normal((4, 3, nd)), jnp.float32))
    ref = ofdm.modulate_symbols(data, cfg)
    monkeypatch.setenv("OFDM_LTE_TPU_CMATMUL", "gauss")
    out = ofdm.modulate_symbols(data, cfg)
    np.testing.assert_allclose(np.asarray(out.re), np.asarray(ref.re),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.im), np.asarray(ref.im),
                               rtol=1e-5, atol=1e-4)


def test_modem_cmatmul_backend_unknown_raises(monkeypatch):
    from ofdm_lte_tpu.cplx import C
    cfg = LTEConfig(bandwidth=1.25, modulation="QPSK")
    nd = grid_for(cfg).num_data
    z = jnp.zeros((2, nd), jnp.float32)
    monkeypatch.setenv("OFDM_LTE_TPU_CMATMUL", "pallas")
    with pytest.raises(ValueError, match="xla4"):
        ofdm.modulate_symbols(C(z, z), cfg)


def test_modem_matches_float64_fft_reference():
    """The reference check chip_smoke.py runs at 20 MHz: modulate and
    demodulate against numpy.fft in float64, at 1.25 MHz on the CPU
    (plain float32 at every precision setting here)."""
    from ofdm_lte_tpu.ops.ofdm_reference import modem_errors
    cfg = LTEConfig(bandwidth=1.25, modulation="64-QAM")
    r = modem_errors(cfg, 4 * 14, seed=3)
    assert r["modulate"] < 1e-5 and r["demodulate"] < 1e-5, r
    # the output holds both float32 planes of the CP-prefixed waveform
    assert r["modulate_memory"].output_size_in_bytes >= 4 * 14 * (
        cfg.N + cfg.cp_length) * 4 * 2


@pytest.mark.gpu
@pytest.mark.parametrize("precision,limit", [("highest", 1e-5),
                                             ("default", 3e-3)])
def test_modem_reference_error_on_gpu(gpu, precision, limit, monkeypatch):
    """On the card `default` runs float32 dots in TF32: the modem's error
    against float64 stays within the TF32 bound at 20 MHz."""
    from ofdm_lte_tpu.ops.ofdm_reference import modem_errors
    monkeypatch.setenv("OFDM_LTE_TPU_MATMUL_PRECISION", precision)
    jax.clear_caches()
    r = modem_errors(LTEConfig(bandwidth=20.0, modulation="64-QAM"), 3584,
                     device=gpu)
    assert r["modulate"] <= limit and r["demodulate"] <= limit, r
