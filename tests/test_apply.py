"""FIR application paths must agree with np.convolve 'same' (K3)."""

import numpy as np
import pytest
import jax.numpy as jnp

from color_modem_tpu.dsp import design
from color_modem_tpu.dsp.apply import fir_same, toeplitz_same

FS = 13.5e6


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 720), dtype=np.float32)
    taps = design.bandpass_taps(FS, 2.2e6, 4.9e6, 129)
    ref = np.stack(
        [np.convolve(x[i].astype(np.float64), taps, "same") for i in range(6)]
    )
    return x, taps, ref


@pytest.mark.parametrize("method", ["matmul", "conv", "fft"])
def test_fir_matches_numpy(method, data):
    x, taps, ref = data
    got = np.asarray(fir_same(jnp.asarray(x), taps, method))
    assert np.abs(got - ref).max() < 2e-5


def test_toeplitz_matrix_structure(data):
    x, taps, ref = data
    mat = toeplitz_same(taps, 720).astype(np.float64)
    got = x.astype(np.float64) @ mat
    # matrix entries are float32 (device dtype); structure must be exact
    assert np.abs(got - ref).max() < 1e-6
    # banded: nothing beyond the filter half-width (sign-blind max() would
    # miss negative leakage — bandpass taps go negative)
    half = (len(taps) - 1) // 2
    assert np.abs(mat[0, half + 1 :]).max() == 0.0
    assert np.allclose(np.diag(mat), taps[half])


def test_asymmetric_taps(data):
    """Non-linear-phase FIRs (SECAM emphasis) must also be exact."""
    taps = design.freq_sampled_taps(
        FS, lambda f: design.secam_preemph_response(f, 85e3), 257
    )
    x = data[0]
    ref = np.stack(
        [np.convolve(x[i].astype(np.float64), taps, "same") for i in range(6)]
    )
    # 'fft' included deliberately: symmetric-taps fixtures cannot detect a
    # convolution-vs-correlation (kernel flip) regression
    for method in ("matmul", "conv", "fft"):
        got = np.asarray(fir_same(jnp.asarray(x), taps, method))
        assert np.abs(got - ref).max() < 2e-5, method


@pytest.mark.parametrize("method", ["matmul", "conv"])
def test_fir_held_matches_numpy(method, data):
    """Held-edge FIR (the SECAM baseband filters) against np.convolve on
    the edge-padded line in float64; same 2e-5 bound as the zero-edge
    paths (float32 products, 129 taps)."""
    from color_modem_tpu.dsp.apply import fir_same_held

    x, taps, _ = data
    h = (len(taps) - 1) // 2
    ref = np.stack([
        np.convolve(np.pad(x[i].astype(np.float64), h, mode="edge"),
                    taps, "same")[h:-h]
        for i in range(len(x))
    ])
    got = np.asarray(fir_same_held(jnp.asarray(x), taps, method))
    assert np.abs(got - ref).max() < 2e-5
