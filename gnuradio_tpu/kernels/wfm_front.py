"""WBFM front end: channel-select complex-tap FIR (decimation D) + FM
discriminator, in two forms that share one algebra.

The rotator vanishes. The freq-xlating filter's output rotator multiplies
y[k] by r[k] = e^{-j w D k} (gr-filter freq_xlating_fir_filter: composite
band-shifted taps + output phasor; rotator renorm
gr-blocks/include/gnuradio/blocks/rotator.h:30-43). The ONLY consumer of the
rotated stream in the WBFM chain is quadrature_demod, which forms
z[k] = y'[k] * conj(y'[k-1]). Since r[k] conj(r[k-1]) = e^{-j w D} is a
CONSTANT,

    z[k] = y[k] conj(y[k-1]) * e^{-j w D}

— the per-sample rotator collapses into one constant complex factor, exact
(not an approximation), with zero phase-accumulator drift by construction.

Forms (`WfmFront.__call__(..., impl=)`):

* "xla" — plain jax: `fir_apply` over the complex stream, then the
  elementwise demod. XLA fuses the demod; the FIR output is one complex
  intermediate in device memory.
* "triton" — one Pallas kernel through Triton. Each program owns BLOCK
  consecutive outputs and loads its own input span plus the T-1+D halo, so
  no state crosses programs: it computes y[k] and y[k-1] for its outputs
  from the same loads (the tile that feeds y[k-1] through taps row m feeds
  y[k] through row m-1). The FIR is a direct-form f32 FMA over polyphase
  tiles X_m[j, p] = xq[D*(k0 + j + m) + p] of shape (BLOCK, DP), with DP the
  next power of two >= D. It reads the two input planes from device memory
  and writes one f32 per output.

Call convention (both forms): the input planes carry (T-1+D) history
samples prepended (zeros at stream start); out[k] is the demod of outputs k
and k-1.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .fir_xla import fir_apply

# outputs per program and warps per program: the fastest of the sizes tried
# on an H100 at the WBFM widths (PERF.md)
BLOCK = 256
NUM_WARPS = 8


def _front_kernel(xr_ref, xi_ref, wr_ref, wi_ref, o_ref, *, D, DP, MW, block,
                  n_out, gain, c0r, c0i):
    n_in = xr_ref.shape[0]
    k = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    ph = jnp.arange(DP, dtype=jnp.int32)
    base = k[:, None] * D + ph[None, :]                     # (block, DP)
    pmask = ph[None, :] < D
    zeros = jnp.zeros((block, DP), jnp.float32)
    ycr, yci, ypr, ypi = zeros, zeros, zeros, zeros
    w = [(plgpu.load(wr_ref.at[m * DP + ph])[None, :],
          plgpu.load(wi_ref.at[m * DP + ph])[None, :]) for m in range(MW)]
    for m in range(MW + 1):
        idx = base + m * D
        mask = (idx < n_in) & pmask
        xr = plgpu.load(xr_ref.at[idx], mask=mask, other=0.0)
        xi = plgpu.load(xi_ref.at[idx], mask=mask, other=0.0)
        if m < MW:                     # y[k-1]: tile m, taps row m
            wr, wi = w[m]
            ypr = ypr + xr * wr - xi * wi
            ypi = ypi + xr * wi + xi * wr
        if m >= 1:                     # y[k]: tile m, taps row m-1
            wr, wi = w[m - 1]
            ycr = ycr + xr * wr - xi * wi
            yci = yci + xr * wi + xi * wr
    ycr, yci = jnp.sum(ycr, axis=1), jnp.sum(yci, axis=1)
    ypr, ypi = jnp.sum(ypr, axis=1), jnp.sum(ypi, axis=1)
    # z = y * conj(y_prev) * e^{-jwD}
    zr0 = ycr * ypr + yci * ypi
    zi0 = yci * ypr - ycr * ypi
    zr = zr0 * c0r - zi0 * c0i
    zi = zr0 * c0i + zi0 * c0r
    plgpu.store(o_ref.at[k], gain * jnp.arctan2(zi, zr), mask=k < n_out)


@functools.partial(jax.jit, static_argnames=("D", "n_out", "gain", "c0",
                                             "interpret"))
def _front_triton(xr, xi, wr, wi, D: int, n_out: int, gain: float,
                  c0: complex, interpret: bool = False):
    """xr/xi: (T-1+D + n_in,) f32 planes; wr/wi: (MW*DP,) f32 reversed
    taps as polyphase rows. Returns (n_out,) f32."""
    DP = pl.next_power_of_2(D)
    kernel = functools.partial(
        _front_kernel, D=D, DP=DP, MW=wr.shape[0] // DP, block=BLOCK,
        n_out=n_out, gain=float(gain), c0r=float(np.real(c0)),
        c0i=float(np.imag(c0)))
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_out,), jnp.float32),
        grid=(pl.cdiv(n_out, BLOCK),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="wfm_front",
    )(xr, xi, wr, wi)


class WfmFront:
    """Channel-select complex-tap FIR (decim D) + quadrature demod.

    Matches FreqXlatingFirFilter(D, taps, fc, fs) -> QuadratureDemod(gain)
    up to f32 rounding (the rotator collapses into e^{-jwD}, see module
    docstring)."""

    def __init__(self, taps, center_freq: float, samp_rate: float,
                 decim: int, gain: float):
        base = np.asarray(taps, np.float64)
        self.T = len(base)
        self.D = int(decim)
        w = 2 * np.pi * center_freq / samp_rate
        ctaps = base * np.exp(1j * w * np.arange(self.T))
        self.ctaps = ctaps.astype(np.complex64)         # convolution order
        # reversed taps as (MW, DP) polyphase rows for the Triton kernel:
        # row m, phase p holds wr[D*m + p] (zero for p >= D or past T)
        D, DP = self.D, pl.next_power_of_2(self.D)
        MW = -(-self.T // D)
        rows = np.zeros((MW, DP), np.complex128)
        wrev = np.concatenate([ctaps[::-1], np.zeros(MW * D - self.T)])
        rows[:, :D] = wrev.reshape(MW, D)
        self.w_rows = (rows.real.astype(np.float32).reshape(-1),
                       rows.imag.astype(np.float32).reshape(-1))
        self.c0 = complex(np.exp(-1j * w * D))
        self.gain = float(gain)
        self.history = self.T - 1 + self.D

    def __call__(self, xr, xi, impl: str, interpret: bool = False):
        """xr/xi: (history + n_in,) f32 I/Q planes with history prepended.
        Returns (n_in // D,) f32 demodulated quad-rate stream."""
        n_out = (xr.shape[0] - self.history) // self.D
        if impl == "triton":
            return _front_triton(xr, xi, jnp.asarray(self.w_rows[0]),
                                 jnp.asarray(self.w_rows[1]), self.D, n_out,
                                 self.gain, self.c0, interpret)
        if impl != "xla":
            raise ValueError(f"unknown WBFM front impl {impl!r}")
        # y[k'] for k' = 0..n_out: y_prev = y[:-1], y_cur = y[1:]
        y = fir_apply(lax.complex(xr, xi), jnp.asarray(self.ctaps), self.D)
        z = y[1:n_out + 1] * jnp.conj(y[:n_out]) * jnp.complex64(self.c0)
        return self.gain * jnp.arctan2(z.imag, z.real)
