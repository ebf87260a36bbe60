"""gr-wavelet analog: discrete wavelet transform blocks.

Reference parity: gr-wavelet/lib/wavelet_ff_impl.cc wraps GSL's
gsl_wavelet_transform (Daubechies family, periodic boundary), squash_ff,
wvps_ff (wavelet power spectrum). Here the DWT is the standard pyramid
filter bank evaluated as batched convolutions (periodic wrap) — matmul/elementwise
friendly, no GSL.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..core.block import Block
from ..core.stream import PortSpec, F

# Daubechies scaling coefficients (orthonormal, sum = sqrt(2)) — standard
# published constants (the same family GSL implements)
_DB = {
    2: [0.7071067811865476, 0.7071067811865476],  # Haar
    4: [0.48296291314469025, 0.836516303737469,
        0.22414386804185735, -0.12940952255092145],
    6: [0.3326705529509569, 0.8068915093133388, 0.4598775021193313,
        -0.13501102001039084, -0.08544127388224149, 0.035226291882100656],
    8: [0.23037781330885523, 0.7148465705525415, 0.6308807679295904,
        -0.02798376941698385, -0.18703481171888114, 0.030841381835986965,
        0.032883011666982945, -0.010597401784997278],
}


def _qmf(h):
    h = np.asarray(h)
    g = h[::-1].copy()
    g[1::2] *= -1
    return g


def _depth(n: int, order: int, levels: int | None) -> tuple:
    """(decomposition depth, final approx length) — a band shorter than the
    filter stops the pyramid (both directions must agree)."""
    max_lv = int(math.log2(n)) if levels is None else levels
    d, m = 0, n
    while d < max_lv and m >= order and m >= 2:
        m //= 2
        d += 1
    return d, m


def dwt_forward(x, order: int = 4, levels: int | None = None):
    """Periodic DWT pyramid. x: [..., n] (n = 2^m) -> same-shape array laid
    out [approx | detail_L | detail_{L-1} | ... | detail_1] (GSL layout)."""
    h = jnp.asarray(_DB[order], jnp.float32)
    g = jnp.asarray(_qmf(_DB[order]), jnp.float32)
    n = x.shape[-1]
    depth, _ = _depth(n, order, levels)
    out = jnp.asarray(x, jnp.float32)
    details = []
    cur = out
    for _ in range(depth):
        m = cur.shape[-1]
        # periodic extension then polyphase downsample
        ext = jnp.concatenate([cur, cur[..., : len(_DB[order]) - 1]], axis=-1)
        a = jnp.stack([jnp.sum(ext[..., 2 * i: 2 * i + order] * h, axis=-1)
                       for i in range(m // 2)], axis=-1)
        d = jnp.stack([jnp.sum(ext[..., 2 * i: 2 * i + order] * g, axis=-1)
                       for i in range(m // 2)], axis=-1)
        details.append(d)
        cur = a
    return jnp.concatenate([cur] + details[::-1], axis=-1)


def dwt_inverse(coeffs, order: int = 4, levels: int | None = None):
    """Inverse of dwt_forward (periodic)."""
    h = np.asarray(_DB[order], np.float32)
    g = _qmf(_DB[order]).astype(np.float32)
    n = coeffs.shape[-1]
    _, alen = _depth(n, order, levels)
    approx = coeffs[..., :alen]
    pos = alen
    sizes = []
    m = alen
    while m < n:
        sizes.append(m)
        m *= 2
    for size in sizes:
        d = coeffs[..., pos: pos + size]
        pos += size
        m2 = size * 2
        up_a = jnp.zeros(coeffs.shape[:-1] + (m2,), jnp.float32)
        up_a = up_a.at[..., 0::2].set(approx)
        up_d = jnp.zeros_like(up_a)
        up_d = up_d.at[..., 0::2].set(d)
        # periodic synthesis: correlate with time-reversed filters
        hr = jnp.asarray(h[::-1].copy())
        gr = jnp.asarray(g[::-1].copy())
        exta = jnp.concatenate([up_a[..., -(len(h) - 1):], up_a], axis=-1)
        extd = jnp.concatenate([up_d[..., -(len(h) - 1):], up_d], axis=-1)
        approx = jnp.stack(
            [jnp.sum(exta[..., i: i + len(h)] * hr, axis=-1)
             + jnp.sum(extd[..., i: i + len(h)] * gr, axis=-1)
             for i in range(m2)], axis=-1)
    return approx


class WaveletFF(Block):
    """wavelet_ff: vlen-sized float vectors -> DWT coefficients."""

    def __init__(self, size: int, order: int = 4, forward: bool = True,
                 name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(F, size),)
        self.out_ports = (PortSpec(F, size),)
        self.order, self.forward = order, forward

    def apply(self, state, inputs, n_in):
        fn = dwt_forward if self.forward else dwt_inverse
        return state, (fn(inputs[0], self.order),)


def wavelet_ff(size, order=4, forward=True):
    return WaveletFF(size, order, forward)


class SquashFF(Block):
    """squash_ff: remap samples between frequency grids by linear
    interpolation (gr-wavelet/lib/squash_ff_impl.cc)."""

    def __init__(self, igrid, ogrid, name=None):
        super().__init__(name)
        self.igrid = np.asarray(igrid, np.float64)
        self.ogrid = np.asarray(ogrid, np.float64)
        self.in_ports = (PortSpec(F, len(self.igrid)),)
        self.out_ports = (PortSpec(F, len(self.ogrid)),)

    def apply(self, state, inputs, n_in):
        x = inputs[0]
        out = jnp.stack(
            [jnp.interp(jnp.asarray(self.ogrid, jnp.float32),
                        jnp.asarray(self.igrid, jnp.float32), row)
             for row in x], axis=0)
        return state, (out.astype(jnp.float32),)


class WvpsFF(Block):
    """wvps_ff: wavelet power spectrum — mean squared detail coefficients
    per octave (ilen -> log2-ish olen vector)."""

    def __init__(self, ilen: int, order: int = 4, name=None):
        super().__init__(name)
        self.ilen = ilen
        self.order = order
        self.olen = int(math.ceil(math.log2(ilen)))
        self.in_ports = (PortSpec(F, ilen),)
        self.out_ports = (PortSpec(F, self.olen),)

    def apply(self, state, inputs, n_in):
        c = dwt_forward(inputs[0], self.order)
        bands = []
        pos = 1
        size = 1
        while pos < self.ilen and len(bands) < self.olen:
            bands.append(jnp.mean(c[..., pos: pos + size] ** 2, axis=-1))
            pos += size
            size *= 2
        while len(bands) < self.olen:
            bands.append(jnp.zeros(c.shape[:-1], jnp.float32))
        return state, (jnp.stack(bands, axis=-1),)


def wvps_ff(ilen, order=4):
    return WvpsFF(ilen, order)
