"""Overlap-save FFT convolution (ops/fft_conv.py) vs direct convolution.

Replaces the whole-signal FFT pair of the reference's convolve
(reference AudioCombination.cpp:299-353) with blocked batched transforms.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from flan_tpu.ops.fft_conv import fft_convolve_full, _plan


@pytest.mark.parametrize("n,m", [(5000, 300), (300, 5000), (9000, 9000),
                                 (40961, 1234)])
def test_matches_numpy_convolve(n, m):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, n)).astype(np.float32)
    h = rng.standard_normal((2, m)).astype(np.float32)
    y = np.asarray(fft_convolve_full(jnp.asarray(x), jnp.asarray(h)))
    assert y.shape == (2, n + m - 1)
    ref = np.stack([np.convolve(x[c], h[c]) for c in range(2)])
    assert np.abs(y - ref).max() < 2e-5 * np.abs(ref).max()


def test_plan_blocks_long_signals():
    dft, step, nb = _plan(48000 * 30, 48000)
    assert dft <= (1 << 18) and nb > 1
    # blocking covers the full linear convolution
    assert nb * step >= 48000 * 30 + 48000 - 1


def test_too_long_ir_falls_back():
    assert _plan(10, 1 << 18) is None
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 500)).astype(np.float32)
    h = rng.standard_normal((1, 400)).astype(np.float32)
    y = np.asarray(fft_convolve_full(jnp.asarray(x), jnp.asarray(h)))
    ref = np.convolve(x[0], h[0])[None]
    assert np.abs(y - ref).max() < 2e-5 * np.abs(ref).max()


def _conv_ref(x, h):
    """Float64 linear convolution per channel: np.convolve where cheap,
    an exact float64 FFT product for the long plan-edge cases."""
    n, m = x.shape[-1], h.shape[-1]
    if n * m <= 5e7:
        return np.stack([np.convolve(x[c].astype(np.float64),
                                     h[c].astype(np.float64))
                         for c in range(x.shape[0])])
    size = 1 << (n + m - 2).bit_length()
    spec = (np.fft.rfft(x.astype(np.float64), size)
            * np.fft.rfft(h.astype(np.float64), size))
    return np.fft.irfft(spec, size)[:, :n + m - 1]


# (n, m) on the overlap-save plan's edges (_plan: dft = max(4096,
# 2 * pow2(m)), step = dft - m + 1)
@pytest.mark.parametrize("n,m", [
    (2051, 2048),            # m at the 4096-point limit, exactly 2 blocks
    (2052, 2048),            # one sample more: a third block
    (4096, 2049),            # m one past the limit: dft 8192, one block
    (7000, 1),               # one-tap response
    ((1 << 17) + 5, 1 << 17),  # the largest blocked transform (2^18)
    ((1 << 17) + 5, (1 << 17) + 1),  # past _MAX_DFT: whole-signal path
])
def test_fft_convolve_full_at_plan_edges(n, m):
    rng = np.random.default_rng(n + m)
    x = rng.standard_normal((2, n)).astype(np.float32)
    h = rng.standard_normal((2, m)).astype(np.float32)
    y = np.asarray(fft_convolve_full(jnp.asarray(x), jnp.asarray(h)))
    ref = _conv_ref(x, h)
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() < 2e-5 * np.abs(ref).max()


# (n, k) on the FIR block plan's edges (fir_apply: fft = min(max(
# pow2(2k), 8192), 2^18), grown when k exceeds half of it; L = fft - k + 1)
@pytest.mark.parametrize("n,k", [
    (4097, 4096),            # exactly one block of L = 4097
    (8194, 4096),            # exactly two blocks
    (8195, 4096),            # one sample into a third block
    (12288, 4097),           # k one past: fft 16384, one block
    (9000, 1),               # one tap: y == h[0] * x
    (1 << 18, (1 << 17) + 1),  # k past the 2^18 cap: fft grows to 2^19
])
def test_fir_apply_at_plan_edges(n, k):
    from flan_tpu.ops.fir import fir_apply
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((2, n)).astype(np.float32)
    h = (rng.standard_normal(k) * np.exp(-np.arange(k) / 500.0)).astype(
        np.float32)
    y = np.asarray(fir_apply(jnp.asarray(x), jnp.asarray(h)))
    ref = _conv_ref(x, np.tile(h, (2, 1)))[:, :n]
    assert y.shape == (2, n)
    assert np.abs(y - ref).max() < 2e-5 * np.abs(ref).max()
