"""Transform primitives of ops/stft.py against float64 numpy."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flan_tpu.ops.stft import cumsum_mod1_frames, irfft_polar, rfft_mag_phase


def test_cumsum_mod1():
    rng = np.random.default_rng(2)
    x = rng.random((2, 1000, 5)).astype(np.float32)
    y = np.asarray(cumsum_mod1_frames(jnp.asarray(x)))
    ref = np.mod(np.cumsum(x.astype(np.float64), axis=1), 1.0)
    d = np.abs(y - ref)
    d = np.minimum(d, 1.0 - d)  # circular distance
    assert d.max() < 5e-4
    assert (y >= 0).all() and (y < 1).all()


@pytest.mark.parametrize("m,n", [(256, 256), (300, 1024), (2048, 4096)])
def test_rfft_mag_phase_matches_numpy(m, n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, m)).astype(np.float32)
    mag, phase = rfft_mag_phase(jnp.asarray(x), n)
    ref = np.fft.rfft(x.astype(np.float64), n=n, axis=-1)
    got = np.asarray(mag, np.float64) * np.exp(1j * np.asarray(phase))
    assert np.abs(got - ref).max() < 2e-5 * np.abs(ref).max()
    assert (np.asarray(mag) >= 0).all()
    assert np.abs(np.asarray(phase)).max() <= np.pi + 1e-6


def test_rfft_mag_phase_zero_frames_are_exact_and_differentiable():
    """All-zero frames (padded lead-in, silence) give mag 0 and phase 0,
    and the polar extraction's gradient there is finite."""
    x = jnp.zeros((1, 4, 64), jnp.float32).at[0, 2].set(
        jnp.sin(jnp.arange(64.0)))
    mag, phase = rfft_mag_phase(x, 64)
    assert float(jnp.abs(mag[0, 0]).max()) == 0.0
    assert float(jnp.abs(phase[0, 0]).max()) == 0.0

    def loss(v):
        m, p = rfft_mag_phase(v, 64)
        return jnp.sum(m) + jnp.sum(jnp.sin(p))

    g = jax.grad(loss)(x)
    assert np.isfinite(np.asarray(g)).all()
    g0 = jax.grad(loss)(jnp.zeros((1, 2, 64), jnp.float32))
    assert np.isfinite(np.asarray(g0)).all()


@pytest.mark.parametrize("n", [256, 4096])
def test_irfft_polar_inverts_rfft_mag_phase(n):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, n)).astype(np.float32)
    mag, phase = rfft_mag_phase(jnp.asarray(x), n)
    y = np.asarray(irfft_polar(mag, phase, n))
    np.testing.assert_allclose(y, x, atol=2e-5)


@pytest.mark.parametrize("n", [256, 255])
def test_irfft_polar_ignores_imaginary_dc_and_nyquist(n):
    """Phases at the DC and (even n) Nyquist bins contribute their real
    parts only, as FFTW's c2r does, whatever the backend's FFT."""
    rng = np.random.default_rng(n)
    b = n // 2 + 1
    mag = rng.random((2, b)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, b)).astype(np.float32)
    y = np.asarray(irfft_polar(jnp.asarray(mag), jnp.asarray(phase), n))
    spec = mag.astype(np.float64) * np.exp(1j * phase.astype(np.float64))
    spec[:, 0] = spec[:, 0].real
    if n % 2 == 0:
        spec[:, -1] = spec[:, -1].real
    np.testing.assert_allclose(y, np.fft.irfft(spec, n), atol=1e-6)
