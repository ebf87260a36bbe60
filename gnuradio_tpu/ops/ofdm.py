"""OFDM blocks — carrier allocation, cyclic prefix, Schmidl & Cox sync,
channel estimation, frame equalization, serialization.

Reference parity map (gr-digital OFDM set, SURVEY.md §2.2):
  ofdm_carrier_allocator_cvc (lib/ofdm_carrier_allocator_cvc_impl.cc):
      data symbols -> occupied carriers, pilots inserted, sync words
      prepended; output (nframes, fft_len) frequency-domain frames.
  ofdm_cyclic_prefixer (lib/ofdm_cyclic_prefixer_impl.cc)
  ofdm_sync_sc_cfb (lib/ofdm_sync_sc_cfb_impl.cc, Schmidl & Cox): the
      P(d)/R(d) metric is two moving sums — computed for ALL lags at once
      with cumulative sums (one pass, no per-sample loop), fine frequency
      offset from arg P(d).
  ofdm_chanest_vcvc (lib/ofdm_chanest_vcvc_impl.cc): LS estimate from the
      known sync symbol(s).
  ofdm_frame_equalizer_vcvc (lib/ofdm_frame_equalizer_vcvc_impl.cc) with
      ofdm_equalizer_static / simpledfe (lib/ofdm_equalizer_*.cc).
  ofdm_serializer_vcc (lib/ofdm_serializer_vcc_impl.cc)

Everything operates on (nframes, fft_len) batches — the streaming tagged
frames of the reference become a leading batch axis that XLA tiles freely.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.stream import C, F


# --- default carrier plan (digital.ofdm_txrx defaults) ---------------------
FFT_LEN = 64
CP_LEN = 16


def default_occupied_carriers(fft_len=FFT_LEN):
    """ofdm_txrx.py _def_occupied_carriers: -26..26 minus pilots & DC."""
    occ = [c for c in range(-26, 27)
           if c not in (-21, -7, 0, 7, 21)]
    return tuple(occ)


DEFAULT_PILOT_CARRIERS = (-21, -7, 7, 21)
DEFAULT_PILOT_SYMBOLS = (1.0, 1.0, 1.0, -1.0)


def schmidl_cox_preamble(fft_len=FFT_LEN, seed=42):
    """Sync words like ofdm_txrx.py _make_sync_word1/2: word1 occupies every
    OTHER carrier (giving the half-symbol time repetition S&C needs), word2
    occupies all occupied carriers; PN symbols from a fixed seed."""
    rng = np.random.default_rng(seed)
    occ = default_occupied_carriers(fft_len)
    w1 = np.zeros(fft_len, np.complex64)
    w2 = np.zeros(fft_len, np.complex64)
    pn = rng.choice([-1.0, 1.0], size=fft_len) * np.sqrt(2)
    for c in occ:
        k = c % fft_len
        if c % 2 == 0:
            w1[k] = pn[k]
        w2[k] = rng.choice([-1.0, 1.0])
    return w1, w2


def allocate_carriers(data_syms, n_data_frames, fft_len=FFT_LEN,
                      occupied_carriers=None, pilot_carriers=DEFAULT_PILOT_CARRIERS,
                      pilot_symbols=DEFAULT_PILOT_SYMBOLS, sync_words=None):
    """ofdm_carrier_allocator_cvc: pack data symbols into frequency-domain
    frames. data_syms: (n_data_frames * n_occ,) complex. Returns
    (n_sync + n_data_frames, fft_len) complex."""
    occ = occupied_carriers or default_occupied_carriers(fft_len)
    occ_idx = np.asarray([c % fft_len for c in occ], np.int32)
    pil_idx = np.asarray([c % fft_len for c in pilot_carriers], np.int32)
    n_occ = len(occ_idx)
    D = data_syms.reshape(n_data_frames, n_occ)
    # scatter -> one-hot matmul (S is (n_occ, fft) with one 1 per row,
    # HIGHEST keeps f32 exact)
    S = np.zeros((n_occ, fft_len), np.float32)
    S[np.arange(n_occ), occ_idx] = 1.0
    Sj = jnp.asarray(S)

    def place(v):
        return jnp.matmul(v, Sj, precision=jax.lax.Precision.HIGHEST)

    frames = jax.lax.complex(place(jnp.real(D)), place(jnp.imag(D)))
    pil_row = np.zeros(fft_len, np.complex64)
    pil_row[pil_idx] = np.asarray(pilot_symbols, np.complex64)
    frames = frames + jnp.asarray(pil_row)[None, :]
    if sync_words:
        sw = jnp.asarray(np.stack(sync_words).astype(np.complex64))
        frames = jnp.concatenate([sw, frames], axis=0)
    return frames


def dft_apply(frames, fft_len: int, inverse: bool = False):
    """(I)DFT along the last axis. For fft_len <= 256 this is a plane
    matmul against the DFT matrix at HIGHEST precision; larger sizes use
    jnp.fft. Scaling matches jnp.fft (unnormalized forward, 1/N inverse)."""
    if fft_len > 256:
        return (jnp.fft.ifft(frames, axis=-1) if inverse
                else jnp.fft.fft(frames, axis=-1))
    k = np.arange(fft_len)
    sign = 2j if inverse else -2j
    Wm = np.exp(sign * np.pi * np.outer(k, k) / fft_len)
    if inverse:
        Wm = Wm / fft_len
    Wr = jnp.asarray(Wm.real.astype(np.float32))
    Wi = jnp.asarray(Wm.imag.astype(np.float32))
    fr, fi = jnp.real(frames), jnp.imag(frames)
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    return jax.lax.complex(mm(fr, Wr) - mm(fi, Wi),
                           mm(fr, Wi) + mm(fi, Wr))


def ofdm_modulate(freq_frames, cp_len=CP_LEN):
    """IFFT + cyclic prefix -> serialized time-domain samples.
    (fft_vcc inverse + ofdm_cyclic_prefixer; FFTW-convention unnormalized
    IFFT scaled by 1/fft_len like the reference generator chain)."""
    td = dft_apply(freq_frames, freq_frames.shape[-1], inverse=True)
    with_cp = jnp.concatenate([td[:, -cp_len:], td], axis=1)
    return with_cp.reshape(-1).astype(C)


def schmidl_cox_metric(x, fft_len=FFT_LEN):
    """Schmidl & Cox timing metric for every lag d (vectorized):
        P(d) = sum_{m<L} conj(x[d+m]) x[d+m+L],  L = fft_len/2
        R(d) = sum_{m<L} |x[d+m+L]|^2
        M(d) = |P(d)|^2 / R(d)^2
    (ofdm_sync_sc_cfb_impl.cc builds this from moving-average blocks; here
    the length-L windowed sums are direct FIR dots (matmul) — NOT
    cumulative-sum differencing, which catastrophically cancels in float32
    when a strong burst precedes a quiet region and makes M garbage there.)
    Returns (M, P) arrays of length len(x) - fft_len."""
    from ..kernels.fir_xla import fir_apply
    L = fft_len // 2
    ones = np.ones(L, np.float32)
    prod = jnp.conj(x[:-L]) * x[L:]
    P = fir_apply(prod, ones, 1)            # P[d] = sum prod[d..d+L-1]
    # Normalize by the FULL-window energy (Minn's variant of S&C): the
    # reference normalizes by the second half only
    # (ofdm_sync_sc_cfb_impl.cc), which explodes at burst ENDS where the
    # second half is quiet (P mixes burst x noise, R ~ noise^2). Halving the
    # full-window energy is identical on true preambles (both halves equal)
    # and suppresses the end spike — documented substitution.
    mag = (jnp.abs(x) ** 2).astype(jnp.float32)
    R = fir_apply(mag, np.ones(fft_len, np.float32), 1) * 0.5
    n = x.shape[0] - fft_len
    P = P[:n]
    R = jnp.maximum(R[:n], 1e-12)
    M = jnp.abs(P) ** 2 / (R ** 2)
    return M, P


def schmidl_cox_detect(x, fft_len=FFT_LEN, cp_len=CP_LEN, threshold=0.8):
    """Locate the frame start and coarse+fine frequency offset.
    Returns (d_start, fine_freq_rad_per_sample). The plateau of M spans
    cp_len; we take the plateau midpoint like the reference's
    plateau_detector_fb."""
    M, P = schmidl_cox_metric(x, fft_len)
    above = M > threshold
    first = jnp.argmax(above)  # first True (plateau leading edge ~ CP start)
    L = fft_len // 2
    # average P over the plateau interior for a lower-variance frequency
    # estimate (multipath + noise bias the single-lag angle)
    w = cp_len // 2
    span = jax.lax.dynamic_slice(P, (first + 2,), (w,))
    fine = jnp.angle(jnp.sum(span)) / L  # rad/sample
    # Demod start must sit EARLY inside the CP: a late window crosses the
    # next symbol (ISI on every carrier); an early one is a circular shift
    # the channel estimate absorbs as linear phase. Back off from the edge,
    # leaving room for channel delay spread at the CP front.
    d = jnp.maximum(first - 6, 0)
    return d, fine


def ofdm_demodulate(x, n_frames, fft_len=FFT_LEN, cp_len=CP_LEN, start=0):
    """CP removal + FFT: x time samples from `start` -> (n_frames, fft_len)
    frequency frames."""
    sym_len = fft_len + cp_len
    need = n_frames * sym_len
    seg = jax.lax.dynamic_slice(x, (start,), (need,))
    frames = seg.reshape(n_frames, sym_len)[:, cp_len:]
    return dft_apply(frames, fft_len)


def ls_channel_estimate(rx_sync, sync_word, fft_len=FFT_LEN):
    """ofdm_chanest_vcvc LS estimate on carriers where sync_word != 0;
    neighbor-interpolated elsewhere (impl.cc interpolates odd carriers for
    the every-other-carrier sync word 1)."""
    sw = jnp.asarray(sync_word)
    active = jnp.abs(sw) > 1e-9
    H = jnp.where(active, rx_sync / jnp.where(active, sw, 1.0), 0.0)
    # Fill inactive carriers (pilots, DC) by GEOMETRIC interpolation of the
    # two active neighbors: a timing offset of s samples puts a linear phase
    # e^{j 2 pi k s / N} on H, so arithmetic neighbor-copy is up to a full
    # carrier of phase wrong — the phase midpoint sqrt(Hl*Hr) is exact for
    # any linear phase (impl.cc interpolates similarly for the
    # every-other-carrier sync word).
    Hl = jnp.roll(H, 1)    # left neighbor (k-1)
    Hr = jnp.roll(H, -1)   # right neighbor (k+1)
    both = (jnp.abs(Hl) > 0) & (jnp.abs(Hr) > 0)
    ratio = Hr * jnp.conj(Hl)
    geo = Hl * jnp.exp(0.5j * jnp.angle(ratio)) * jnp.sqrt(
        jnp.maximum(jnp.abs(Hr) / jnp.maximum(jnp.abs(Hl), 1e-12), 0.0))
    fill = jnp.where(both, geo, jnp.where(jnp.abs(Hl) > 0, Hl, Hr))
    return jnp.where(active, H, fill)


def equalize_static(frames, H):
    """ofdm_equalizer_static: divide by the channel estimate."""
    Hs = jnp.where(jnp.abs(H) > 1e-9, H, 1.0)
    return frames / Hs[None, :]


def equalize_simpledfe(frames, H, constellation_points, pilot_carriers=None,
                       pilot_symbols=None, fft_len=FFT_LEN, alpha=0.1):
    """ofdm_equalizer_simpledfe (lib/ofdm_equalizer_simpledfe.cc): symbol-by-
    symbol decision feedback: for each OFDM symbol, equalize with current H,
    decide nearest constellation point (or known pilot), update
    H <- (1-alpha) H + alpha * rx/decision. Sequential across OFDM symbols
    (a few dozen) — lax.scan over frames, vectorized across carriers."""
    pts = jnp.asarray(np.asarray(constellation_points, np.complex64))
    pil_idx = (jnp.asarray([c % fft_len for c in pilot_carriers], jnp.int32)
               if pilot_carriers else None)
    pil_sym = (jnp.asarray(np.asarray(pilot_symbols, np.complex64))
               if pilot_symbols is not None else None)

    def step(H, y):
        Hs = jnp.where(jnp.abs(H) > 1e-9, H, 1.0)
        eq = y / Hs
        if pil_idx is not None:
            # common phase error from pilots (residual CFO shows up as a
            # per-OFDM-symbol rotation; the reference's simpledfe absorbs it
            # into H slowly — explicit CPE correction is faster and exact)
            cpe = jnp.angle(jnp.sum(eq[pil_idx] * jnp.conj(pil_sym)))
            eq = eq * jnp.exp(-1j * cpe)
        d = jnp.abs(eq[:, None] - pts[None, :]) ** 2
        dec = pts[jnp.argmin(d, axis=1)]
        if pil_idx is not None:
            dec = dec.at[pil_idx].set(pil_sym)
        active = jnp.abs(dec) > 1e-9
        Hnew = jnp.where(active, (1 - alpha) * H + alpha * y / jnp.where(
            active, dec, 1.0), H)
        return Hnew, eq

    H_final, eq = jax.lax.scan(step, jnp.asarray(H), frames)
    return eq, H_final


def serialize_carriers(frames, fft_len=FFT_LEN, occupied_carriers=None):
    """ofdm_serializer_vcc: extract occupied-carrier data symbols in order
    (gather -> one-hot matmul, see allocate_carriers)."""
    occ = occupied_carriers or default_occupied_carriers(fft_len)
    occ_idx = np.asarray([c % fft_len for c in occ], np.int32)
    S = np.zeros((fft_len, len(occ_idx)), np.float32)
    S[occ_idx, np.arange(len(occ_idx))] = 1.0
    Sj = jnp.asarray(S)

    def pick(v):
        return jnp.matmul(v, Sj, precision=jax.lax.Precision.HIGHEST)

    out = jax.lax.complex(pick(jnp.real(frames)), pick(jnp.imag(frames)))
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# block forms of the TX chain pieces (vlen-vector blocks, GR public names)
# ---------------------------------------------------------------------------
from ..core.block import Block  # noqa: E402
from ..core.stream import PortSpec  # noqa: E402


class OfdmCarrierAllocator(Block):
    """ofdm_carrier_allocator_cvc as a fixed-rate vlen block: n_occ data
    symbols in per frame -> (fft_len,) frequency frame out with pilots
    (sync words are per-burst framing — prepend via vector_insert or the
    burst builders; the reference allocates them from length tags)."""

    def __init__(self, fft_len=FFT_LEN, occupied_carriers=None,
                 pilot_carriers=DEFAULT_PILOT_CARRIERS,
                 pilot_symbols=DEFAULT_PILOT_SYMBOLS, name=None):
        super().__init__(name)
        occ = occupied_carriers or default_occupied_carriers(fft_len)

        def _flat(v):
            # GRC passes allocations as a tuple of per-symbol lists
            # (ofdm_carrier_allocator_cvc.h cycles them); the fixed-rate
            # block form supports the single-allocation case
            if len(v) and isinstance(v[0], (list, tuple, np.ndarray)):
                if len(v) != 1:
                    raise ValueError(
                        "per-symbol cycling allocations not supported by "
                        "the fixed-rate allocator block")
                return list(v[0])
            return list(v)

        occ, pilot_carriers = _flat(occ), _flat(pilot_carriers)
        pilot_symbols = _flat(pilot_symbols)
        self.occ_idx = np.asarray([c % fft_len for c in occ], np.int32)
        self.pil_idx = np.asarray([c % fft_len for c in pilot_carriers],
                                  np.int32)
        self.pil = np.asarray(pilot_symbols, np.complex64)
        self.fft_len = int(fft_len)
        self.n_occ = len(self.occ_idx)
        self.in_ports = (PortSpec(C),)
        self.out_ports = (PortSpec(C, self.fft_len),)

    @property
    def in_rates(self):
        from fractions import Fraction as _Fr
        return (_Fr(self.n_occ),)

    @property
    def out_rates(self):
        from fractions import Fraction as _Fr
        return (_Fr(1),)

    def apply(self, state, inputs, n_in):
        d = inputs[0].reshape(-1, self.n_occ)
        k = d.shape[0]
        out = jnp.zeros((k, self.fft_len), C)
        out = out.at[:, jnp.asarray(self.occ_idx)].set(d.astype(C))
        out = out.at[:, jnp.asarray(self.pil_idx)].set(
            jnp.asarray(self.pil)[None, :])
        return state, (out,)


def ofdm_carrier_allocator_cvc(fft_len=FFT_LEN, occupied_carriers=None,
                               pilot_carriers=DEFAULT_PILOT_CARRIERS,
                               pilot_symbols=DEFAULT_PILOT_SYMBOLS):
    return OfdmCarrierAllocator(fft_len, occupied_carriers, pilot_carriers,
                                pilot_symbols)


class OfdmCyclicPrefixer(Block):
    """ofdm_cyclic_prefixer: (fft_len,) time-domain frames in -> serialized
    samples with the cyclic prefix prepended per frame."""

    def __init__(self, fft_len=FFT_LEN, cp_len=CP_LEN, name=None):
        super().__init__(name)
        self.fft_len, self.cp_len = int(fft_len), int(cp_len)
        self.in_ports = (PortSpec(C, self.fft_len),)
        self.out_ports = (PortSpec(C),)

    @property
    def in_rates(self):
        from fractions import Fraction as _Fr
        return (_Fr(1),)

    @property
    def out_rates(self):
        from fractions import Fraction as _Fr
        return (_Fr(self.fft_len + self.cp_len),)

    def apply(self, state, inputs, n_in):
        td = inputs[0]
        with_cp = jnp.concatenate([td[:, -self.cp_len:], td], axis=1)
        return state, (with_cp.reshape(-1),)


def ofdm_cyclic_prefixer(fft_len=FFT_LEN, cp_len=CP_LEN):
    return OfdmCyclicPrefixer(fft_len, cp_len)
