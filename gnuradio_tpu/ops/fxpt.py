"""Fixed-point NCO / phase accumulation — drift-free long streams.

Reference parity: gnuradio-runtime/lib/math/fxpt.cc, include/gnuradio/fxpt_nco.h
— a 32-bit phase accumulator whose top bits index an interpolated sine table.
The key semantic (SURVEY.md App. C) is that phase wraps EXACTLY mod 2^32, so a
sig_source or frequency modulator never drifts over 10^12 samples the way a
float32 phase accumulator would. We keep the int32 accumulator (JAX/XLA int
arithmetic wraps two's-complement, i.e. exactly mod 2^32) but evaluate
sin/cos with the device's native transcendentals instead of the reference's
LUT — more accurate than the LUT, documented substitution.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

TWO_PI = float(2.0 * np.pi)
# radians <-> fixed point: angle = phase_int * 2^-32 * 2pi
_FXPT_SCALE = np.float32(TWO_PI / 2.0**32)


def float_to_fxpt(angle_rad: float) -> np.int32:
    """Host-side: radians -> int32 phase (wrapping), fxpt.h analog."""
    x = np.float64(angle_rad) / TWO_PI
    x = x - np.floor(x)  # [0,1)
    return np.int64(np.round(x * 2.0**32)).astype(np.int64).astype(np.int32)


def fxpt_to_float(phase):
    """Device-side: int32 phase -> radians in [-pi, pi)."""
    return phase.astype(jnp.float32) * _FXPT_SCALE


def nco_phases(phase0, delta, n: int):
    """Vector of n int32 phases starting at phase0 with increment delta.

    phase0, delta: int32 scalars (device). Returns (phases (n,) int32,
    next_phase int32). Wrapping int32 multiply-add is exact mod 2^32.
    """
    k = jnp.arange(n, dtype=jnp.int32)
    phases = phase0 + delta * k
    nxt = phase0 + delta * jnp.int32(n)
    return phases, nxt


def nco_sincos(phase0, delta, n: int):
    """n unit phasors e^{j angle}: (complex64 (n,), next_phase)."""
    phases, nxt = nco_phases(phase0, delta, n)
    ang = fxpt_to_float(phases)
    return jnp.exp(1j * ang).astype(jnp.complex64), nxt


def nco_sin(phase0, delta, n: int):
    phases, nxt = nco_phases(phase0, delta, n)
    return jnp.sin(fxpt_to_float(phases)), nxt


def nco_cos(phase0, delta, n: int):
    phases, nxt = nco_phases(phase0, delta, n)
    return jnp.cos(fxpt_to_float(phases)), nxt
