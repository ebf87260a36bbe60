"""G.726-family ADPCM vocoders: G.721 (32 kbit/s, 4-bit), G.723_24
(24 kbit/s, 3-bit), G.723_40 (40 kbit/s, 5-bit).

Reference parity: gr-vocoder's g721_encode/decode_bs and
g723_24/g723_40_* blocks (gr-vocoder/lib/g7*_impl.cc wrapping the CCITT
ADPCM sample code). Implemented here FROM THE ALGORITHM STRUCTURE of
ITU-T G.726 — adaptive quantization of the prediction difference in the
log domain, a 2-pole + 6-zero sign-LMS adaptive predictor with stability
clamps, and dual-speed (fast/locked) scale-factor adaptation with the
speed-control mixer — in float arithmetic rather than the spec's exact
fixed-point FLOAT/FMULT format. NOT bit-exact with the CCITT code
(documented substitution, SURVEY.md App. C pattern); it IS a real working
ADPCM whose encoder and decoder track exactly (same state recursions), QA'd
by roundtrip SNR and bit-rate ordering.

Mapping: the per-sample feedback (quantizer scale and predictor adapt
on the quantized output) is inherently sequential -> lax.scan; at vocoder
rates (8 kHz) this costs microseconds per second of speech.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.block import SyncBlock
from ..core.stream import PortSpec, B, F

# Per-rate quantizer tables (log2 domain, spec Tables 13-16 shape):
#   qthr: decision thresholds for |d|ln = log2|d| - y  (len 2^(bits-1) - 1)
#   dqln: inverse-quantizer output levels (len 2^(bits-1))
#   wi  : scale-factor multipliers W(I)
#   fi  : speed-control F(I)
_TABLES = {
    3: {  # G.723_24 — 3-bit design derived from the 4-bit grid by merging
        # adjacent reconstruction levels (levels = pair means, thresholds =
        # midpoints); spec-structure-faithful, see module docstring
        "qthr": np.array([0.19, 1.84, 2.72]),
        "dqln": np.array([-0.98, 1.36, 2.32, 3.12]),
        "wi": np.array([0.19, 3.67, 9.39, 46.21]),
        "fi": np.array([0.0, 1.0, 1.0, 7.0]),
    },
    4: {  # G.721 / G.726-32
        "qthr": np.array([-0.98, 0.62, 1.38, 1.91, 2.34, 2.72, 3.12]),
        "dqln": np.array([-2.04, 0.07, 1.05, 1.66, 2.13, 2.52, 2.91, 3.32]),
        "wi": np.array([-0.75, 1.13, 2.96, 4.38, 7.26, 11.52, 22.38, 70.04]),
        "fi": np.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 3.0, 7.0]),
    },
    5: {  # G.723_40
        "qthr": np.array([-1.54, -0.66, 0.17, 0.84, 1.36, 1.78, 2.13,
                          2.43, 2.69, 2.92, 3.12, 3.31, 3.49, 3.66, 3.81]),
        "dqln": np.array([-2.06, -1.05, -0.25, 0.53, 1.12, 1.58, 1.96, 2.29,
                          2.57, 2.81, 3.02, 3.21, 3.39, 3.58, 3.74, 3.88]),
        "wi": np.array([-0.48, 0.18, 0.78, 1.32, 2.04, 3.12, 4.62, 6.96,
                        9.48, 13.26, 17.28, 22.38, 28.98, 38.46, 49.62,
                        70.04]),
        "fi": np.array([0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0,
                        1.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]),
    },
}

_SCALE = 16384.0  # float [-1,1) -> ~15-bit linear like the CCITT code


def _adpcm_core(bits: int):
    """Build (encode_step, decode_step) sharing the state recursion.

    State: (b[6], a[2], dq_hist[6], sr_hist[2], yu, yl, ap, dms, dml).
    """
    tab = _TABLES[bits]
    qthr = jnp.asarray(tab["qthr"], jnp.float32)
    dqln = jnp.asarray(tab["dqln"], jnp.float32)
    wi = jnp.asarray(tab["wi"], jnp.float32)
    fi = jnp.asarray(tab["fi"], jnp.float32)
    nlev = 1 << (bits - 1)

    def predict(st):
        b, a, dqh, srh = st["b"], st["a"], st["dqh"], st["srh"]
        sez = jnp.sum(b * dqh)
        se = sez + jnp.sum(a * srh)
        return se, sez

    def update(st, dq, sr, I_mag):
        """Common encoder/decoder state update given the quantized
        difference dq (signed), reconstructed sr, and |I|."""
        b, a, dqh, srh = st["b"], st["a"], st["dqh"], st["srh"]
        # --- scale factor adaptation (spec 4.2.4, dual speed) ---
        y = st["ap"] * st["yu"] + (1.0 - st["ap"]) * st["yl"]
        w = wi[I_mag]
        yu = jnp.clip((1 - 2.0 ** -5) * y + 2.0 ** -5 * w, 1.06, 10.0)
        yl = (1 - 2.0 ** -6) * st["yl"] + 2.0 ** -6 * yu
        # --- speed control (spec 4.2.5) ---
        f = fi[I_mag]
        dms = (1 - 2.0 ** -5) * st["dms"] + 2.0 ** -5 * f
        dml = (1 - 2.0 ** -7) * st["dml"] + 2.0 ** -7 * f
        transition = (jnp.abs(dms - dml) >= 2.0 ** -3 * dml) | (y < 3.0)
        ap_target = jnp.where(transition, 1.0, 0.0)
        ap = (1 - 2.0 ** -4) * st["ap"] + 2.0 ** -4 * ap_target
        ap = jnp.clip(ap, 0.0, 1.0)
        # --- predictor adaptation (spec 4.2.6, sign-sign LMS) ---
        sgn_dq = jnp.sign(dq)
        bn = (1 - 2.0 ** -8) * b + 2.0 ** -7 * sgn_dq * jnp.sign(dqh)
        p0 = dq + jnp.sum(b * dqh)           # p(k) = dq + sez
        srh0, srh1 = srh[0], srh[1]
        sgn_p = jnp.sign(p0)
        # a2 then a1 with the spec's stability windows
        f1 = jnp.clip(4 * a[0], -2.0, 2.0)
        a2 = ((1 - 2.0 ** -7) * a[1]
              + 2.0 ** -7 * (sgn_p * jnp.sign(srh1 * 1.0 + 0.0)
                             - f1 * sgn_p * jnp.sign(srh0)) / 4.0)
        a2 = jnp.clip(a2, -0.75, 0.75)
        a1 = (1 - 2.0 ** -8) * a[0] + 3.0 * 2.0 ** -8 * sgn_p * jnp.sign(srh0)
        a1 = jnp.clip(a1, -(0.9375 - a2), 0.9375 - a2)
        return {
            "b": bn, "a": jnp.stack([a1, a2]),
            "dqh": jnp.concatenate([dq[None], dqh[:-1]]),
            "srh": jnp.stack([sr, srh0]),
            "yu": yu, "yl": yl, "ap": ap, "dms": dms, "dml": dml,
        }, y

    def quantize(d, y):
        dln = jnp.log2(jnp.maximum(jnp.abs(d), 1e-6)) - y
        mag = jnp.sum((dln[None] >= qthr).astype(jnp.int32))
        neg = (d < 0).astype(jnp.int32)
        return mag, neg

    def dequantize(mag, neg, y):
        dq = 2.0 ** (dqln[mag] + y)
        return jnp.where(neg > 0, -dq, dq)

    def enc_step(st, x):
        se, _ = predict(st)
        y = st["ap"] * st["yu"] + (1.0 - st["ap"]) * st["yl"]
        d = x - se
        mag, neg = quantize(d, y)
        dq = dequantize(mag, neg, y)
        sr = se + dq
        st2, _ = update(st, dq, sr, mag)
        code = mag | (neg << (bits - 1))
        return st2, code.astype(jnp.int8)

    def dec_step(st, code):
        c = code.astype(jnp.int32)
        mag = c & (nlev - 1)
        neg = (c >> (bits - 1)) & 1
        se, _ = predict(st)
        y = st["ap"] * st["yu"] + (1.0 - st["ap"]) * st["yl"]
        dq = dequantize(mag, neg, y)
        sr = se + dq
        st2, _ = update(st, dq, sr, mag)
        return st2, sr

    def init():
        return {"b": jnp.zeros(6, jnp.float32), "a": jnp.zeros(2, jnp.float32),
                "dqh": jnp.zeros(6, jnp.float32),
                "srh": jnp.zeros(2, jnp.float32),
                "yu": jnp.float32(1.06), "yl": jnp.float32(1.06),
                "ap": jnp.float32(0.0), "dms": jnp.float32(0.0),
                "dml": jnp.float32(0.0)}

    return init, enc_step, dec_step


class AdpcmEncoder(SyncBlock):
    """float [-1,1) in -> ADPCM code byte out (one code per sample, like
    the reference's *_encode_bs blocks)."""

    def __init__(self, bits: int = 4, name=None):
        super().__init__(PortSpec(F), PortSpec(B), name)
        self.bits = int(bits)
        self._init, self._enc, _ = _adpcm_core(self.bits)

    def init_state(self):
        return self._init()

    def work(self, state, x):
        def step(st, xi):
            return self._enc(st, xi * _SCALE)
        st, codes = jax.lax.scan(step, state, x.astype(jnp.float32))
        return st, codes


class AdpcmDecoder(SyncBlock):
    """ADPCM code byte in -> float out."""

    def __init__(self, bits: int = 4, name=None):
        super().__init__(PortSpec(B), PortSpec(F), name)
        self.bits = int(bits)
        self._init, _, self._dec = _adpcm_core(self.bits)

    def init_state(self):
        return self._init()

    def work(self, state, codes):
        st, sr = jax.lax.scan(self._dec, state, codes)
        return st, (sr / _SCALE).astype(jnp.float32)


def g721_encode_bs():
    return AdpcmEncoder(4)


def g721_decode_bs():
    return AdpcmDecoder(4)


def g723_24_encode_bs():
    return AdpcmEncoder(3)


def g723_24_decode_bs():
    return AdpcmDecoder(3)


def g723_40_encode_bs():
    return AdpcmEncoder(5)


def g723_40_decode_bs():
    return AdpcmDecoder(5)
