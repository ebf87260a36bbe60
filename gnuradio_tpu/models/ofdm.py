"""OFDM loopback transceiver — BASELINE.json config #4.

Reference: gr-digital/examples/ofdm/ofdm_loopback.grc — digital_ofdm_tx ->
channels_channel_model -> digital_ofdm_rx (hiers in
gr-digital/python/digital/ofdm_txrx.py:103 (tx) and :249 (rx)).

Functional frame-based form: one jittable TX producing a burst, one
jittable RX recovering the payload through Schmidl&Cox sync, CFO
correction, LS channel estimation and (static or decision-feedback)
equalization. The packet/header machinery of the reference (crc32_bb,
packet_headergenerator) is host-side framing — see ops/digital.crc32.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.digital import constellation_qpsk
from ..ops.ofdm import (CP_LEN, FFT_LEN, allocate_carriers,
                        default_occupied_carriers, equalize_simpledfe,
                        equalize_static, ls_channel_estimate, ofdm_demodulate,
                        ofdm_modulate, schmidl_cox_detect,
                        schmidl_cox_preamble, serialize_carriers,
                        DEFAULT_PILOT_CARRIERS, DEFAULT_PILOT_SYMBOLS)


def ofdm_tx_burst(sym_idx: np.ndarray, fft_len=FFT_LEN, cp_len=CP_LEN,
                  pad: int = 100):
    """Build one OFDM burst from QPSK symbol indices.
    Returns (iq, n_data_frames). len(sym_idx) must fill whole frames."""
    const = constellation_qpsk()
    occ = default_occupied_carriers(fft_len)
    n_occ = len(occ)
    assert len(sym_idx) % n_occ == 0
    nframes = len(sym_idx) // n_occ
    syms = jnp.asarray(const.points)[jnp.asarray(sym_idx, jnp.int32)]
    w1, w2 = schmidl_cox_preamble(fft_len)
    frames = allocate_carriers(syms, nframes, fft_len, occ,
                               DEFAULT_PILOT_CARRIERS, DEFAULT_PILOT_SYMBOLS,
                               sync_words=[w1, w2])
    iq = ofdm_modulate(frames, cp_len)
    z = jnp.zeros(pad, iq.dtype)
    return jnp.concatenate([z, iq, z]), nframes


def ofdm_rx_burst(x, nframes, fft_len=FFT_LEN, cp_len=CP_LEN,
                  equalizer="simpledfe"):
    """Receive one OFDM burst: S&C detect -> CFO correct -> FFT ->
    chanest from sync word 2 -> equalize -> serialize -> decide.
    Returns (sym_idx, diag dict)."""
    const = constellation_qpsk()
    occ = default_occupied_carriers(fft_len)
    d, fine = schmidl_cox_detect(x, fft_len, cp_len)
    n = x.shape[0]
    # frame start: quantize the PLATEAU EDGE down to a multiple of 8 so
    # the slice moves 8-sample ROWS instead of single samples. The
    # <=7-sample early shift plays the role of the old fixed -6 backoff:
    # it stays inside the CP margin and the channel estimate absorbs it
    # as linear phase.
    start = ((d + 6) // 8) * 8      # d = plateau edge - 6 (see detect)
    need = nframes + 2
    sym_len = fft_len + cp_len
    need_rows = need * sym_len // 8
    pad_rows = -((-(n + 8 * 16)) // 8)
    x8 = jnp.pad(x, (0, max(0, pad_rows * 8 - n))).reshape(-1, 8)
    K = x8.shape[0] - need_rows + 1
    row0 = jnp.clip(start // 8, 0, K - 1)
    if K <= 64:
        # one-hot shifted accumulate instead of a per-burst dynamic_slice:
        # under vmap the batched dynamic_slice lowers to a row gather;
        # K weighted static slices fuse into one elementwise pass.
        oh = (jnp.arange(K) == row0).astype(jnp.float32)
        seg2 = jnp.zeros((need_rows, 8), x.dtype)
        for k in range(K):
            seg2 = seg2 + oh[k] * jax.lax.slice_in_dim(x8, k, k + need_rows)
        seg = seg2.reshape(-1)
    else:
        seg = jax.lax.dynamic_slice(
            x8, (row0, 0), (need_rows, 8)).reshape(-1)
    # fine-CFO rotation AFTER the slice with a factorized phase ramp:
    # e^{-jf(8 row0 + 80 m + i)} = s0 * A[m] * C[i] — ~92 sincos per burst
    # instead of one per sample (a full-buffer rotate).
    s0 = jnp.exp(-1j * fine * (8.0 * row0.astype(jnp.float32)))
    A = jnp.exp(-1j * fine * sym_len
                * jnp.arange(need, dtype=jnp.float32))
    Cc = jnp.exp(-1j * fine * jnp.arange(sym_len, dtype=jnp.float32))
    seg = (seg.reshape(need, sym_len)
           * (s0 * A)[:, None] * Cc[None, :]).reshape(-1)
    F = ofdm_demodulate(seg, need, fft_len, cp_len, 0)
    w1, w2 = schmidl_cox_preamble(fft_len)
    H = ls_channel_estimate(F[1], jnp.asarray(w2), fft_len)
    data = F[2:]
    if equalizer == "static":
        eq = equalize_static(data, H)
    else:
        eq, H = equalize_simpledfe(data, H, const.points,
                                   DEFAULT_PILOT_CARRIERS,
                                   DEFAULT_PILOT_SYMBOLS, fft_len)
    syms = serialize_carriers(eq, fft_len, occ)
    idx = const.decision(syms)
    return idx, {"start": d, "fine_cfo": fine, "H": H, "eq_syms": syms}
