"""On-device horizontal resampling (SURVEY.md K12/C7)."""

import numpy as np

import jax.numpy as jnp

from color_modem_tpu.dsp.resample import resample_matrix, resample_width


def test_flat_field_is_exact():
    x = jnp.full((4, 720), 0.37, jnp.float32)
    for n in (704, 768, 1440, 360):
        y = np.asarray(resample_width(x, n))
        np.testing.assert_allclose(y, 0.37, atol=1e-5)


def test_matches_float64_matrix_product():
    """The device resample equals the host matrix applied in float64 to
    1e-5 (float32 products over 17-tap rows, unit-scale input)."""
    rng = np.random.default_rng(3)
    x = rng.random((8, 720)).astype(np.float32)
    for n in (1440, 704):
        ref = x.astype(np.float64) @ resample_matrix(720, n).astype(np.float64)
        got = np.asarray(resample_width(jnp.asarray(x), n))
        assert np.abs(got - ref).max() < 1e-5, n


def test_band_limited_round_trip():
    """720 -> 1440 -> 720 on a band-limited signal is near-lossless."""
    n = 720
    t = np.arange(n)
    x = sum(np.cos(2 * np.pi * f * (t + 0.5) / n + f) for f in (3, 17, 41))
    x = jnp.asarray(x.astype(np.float32))[None]
    up = resample_width(x, 1440)
    back = np.asarray(resample_width(up, 720))[0]
    err = np.abs(back[20:-20] - np.asarray(x)[0][20:-20]).max()
    assert err < 1e-3, err


def test_decimation_antialiases():
    """A tone above the output Nyquist must be attenuated, not aliased."""
    n = 1440
    t = np.arange(n)
    hi = np.cos(2 * np.pi * 600 * (t + 0.5) / n)  # 600 cyc > 720/2 = 360
    y = np.asarray(resample_width(jnp.asarray(hi, jnp.float32)[None], 720))[0]
    assert np.abs(y[20:-20]).max() < 0.05


def test_matrix_rows_sum_to_one():
    m = resample_matrix(720, 768)
    np.testing.assert_allclose(m.sum(axis=0), 1.0, atol=1e-6)
