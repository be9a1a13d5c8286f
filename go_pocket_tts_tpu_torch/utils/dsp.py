"""Opt-in audio post-processing: peak normalize, DC block, fades.

Parity with `internal/audio/dsp.go:12-78` (applied by the `synth` command
behind flags, `cmd/pockettts/synth.go:361-390`):

- :func:`peak_normalize` — scale so the peak hits the target (default 0.95);
  no-op on silence
- :func:`dc_block` — 20 Hz biquad high-pass (Butterworth, matching the
  algo-dsp highpass the reference uses)
- :func:`fade_in` / :func:`fade_out` — linear fades over N milliseconds
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["peak_normalize", "dc_block", "fade_in", "fade_out"]


def peak_normalize(samples: np.ndarray, target: float = 0.95) -> np.ndarray:
    x = np.asarray(samples, dtype=np.float32)
    peak = float(np.max(np.abs(x))) if x.size else 0.0
    if peak <= 0.0 or target <= 0.0:
        return x.copy()
    return (x * (target / peak)).astype(np.float32)


def _highpass_coeffs(sample_rate: int, cutoff_hz: float):
    """RBJ-cookbook high-pass biquad coefficients (Q=1/sqrt(2)), normalized."""
    w0 = 2.0 * math.pi * cutoff_hz / sample_rate
    cosw, sinw = math.cos(w0), math.sin(w0)
    q = 1.0 / math.sqrt(2.0)
    alpha = sinw / (2.0 * q)
    a0 = 1 + alpha
    b0 = (1 + cosw) / 2 / a0
    b1 = -(1 + cosw) / a0
    b2 = (1 + cosw) / 2 / a0
    a1 = -2 * cosw / a0
    a2 = (1 - alpha) / a0
    return b0, b1, b2, a1, a2


def _biquad_numpy(x64: np.ndarray, b0, b1, b2, a1, a2) -> np.ndarray:
    """Vectorized direct-form biquad: decompose the AR part into a complex
    conjugate one-pole pair and run each block as a scaled cumsum.

    For a complex pole ``p`` (conj pair roots of ``z² + a1·z + a2``):
    ``1/(1 + a1 z⁻¹ + a2 z⁻²) = g/(1 − p z⁻¹) + ḡ/(1 − p̄ z⁻¹)`` with
    ``g = p/(p − p̄)``, so ``y = 2·Re(g·w)`` where ``w`` is the one-pole
    recursion ``w[i] = p·w[i−1] + u[i]`` — computed per block as
    ``w = pᶦ·cumsum(u·p⁻ᶦ) + pᶦ⁺¹·w_prev``. Block size bounds ``|p|⁻ᶦ``
    growth so the rescaling stays in float64 range.
    """
    disc = a1 * a1 - 4.0 * a2
    if disc >= 0.0:  # real poles: fall back to the sequential recursion
        y = np.empty_like(x64)
        u1 = u2 = y1 = y2 = 0.0
        for i in range(len(x64)):
            yi = b0 * x64[i] + b1 * u1 + b2 * u2 - a1 * y1 - a2 * y2
            u2, u1 = u1, x64[i]
            y2, y1 = y1, yi
            y[i] = yi
        return y

    # FIR part u[i] = b0·x[i] + b1·x[i−1] + b2·x[i−2] (zero initial state).
    u = b0 * x64
    if len(x64) > 1:
        u[1:] += b1 * x64[:-1]
    if len(x64) > 2:
        u[2:] += b2 * x64[:-2]

    p = complex(-a1 / 2.0, math.sqrt(-disc) / 2.0)
    g = p / (p - p.conjugate())
    y = np.empty_like(x64)
    w_prev = 0.0 + 0.0j
    block = 4096
    pk = p ** np.arange(min(block, len(u)))  # shared across blocks
    inv_pk = 1.0 / pk
    for s in range(0, len(u), block):
        blk = u[s : s + block]
        n = len(blk)
        w = pk[:n] * np.cumsum(blk * inv_pk[:n]) + (pk[:n] * p) * w_prev
        w_prev = complex(w[-1])
        y[s : s + n] = 2.0 * (g * w).real
    return y


def dc_block(samples: np.ndarray, sample_rate: int = 24_000, cutoff_hz: float = 20.0) -> np.ndarray:
    """Biquad high-pass (RBJ cookbook, Q=1/sqrt(2)) at ``cutoff_hz``.

    Runs through the native C++ helper when it loads, else a vectorized
    NumPy path (the same samples within float32 rounding), never a
    per-sample Python loop (≈1.4M iterations per minute of audio).
    """
    x = np.asarray(samples, dtype=np.float32)
    if x.size == 0:
        return x.copy()
    b0, b1, b2, a1, a2 = _highpass_coeffs(sample_rate, cutoff_hz)
    from go_pocket_tts_tpu_torch.native import audioio

    native = audioio.load()
    if native is not None:
        return native.biquad_df1(x, b0, b1, b2, a1, a2)
    return _biquad_numpy(x.astype(np.float64), b0, b1, b2, a1, a2).astype(np.float32)


def fade_in(samples: np.ndarray, sample_rate: int = 24_000, ms: float = 10.0) -> np.ndarray:
    x = np.asarray(samples, dtype=np.float32).copy()
    n = min(len(x), int(sample_rate * ms / 1000.0))
    if n > 0:
        x[:n] *= np.linspace(0.0, 1.0, n, endpoint=False, dtype=np.float32)
    return x


def fade_out(samples: np.ndarray, sample_rate: int = 24_000, ms: float = 10.0) -> np.ndarray:
    x = np.asarray(samples, dtype=np.float32).copy()
    n = min(len(x), int(sample_rate * ms / 1000.0))
    if n > 0:
        x[len(x) - n :] *= np.linspace(1.0, 0.0, n, dtype=np.float32)
    return x
