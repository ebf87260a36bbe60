"""FreeDV digital-voice transceiver — native analog of gr-vocoder's
freedv_tx_ss / freedv_rx_ss (gr-vocoder/lib/freedv_tx_ss_impl.cc:44-90,
freedv_rx_ss_impl.cc), which wrap libcodec2's freedv API (codec2 vocoder +
FDMDV multi-carrier DQPSK modem, short speech in -> short modem samples
out at 8 kHz, and the reverse with sync; a side text channel cycles a
caller-supplied message one char per frame).

Documented substitution (SURVEY.md App. C discipline): the external
libcodec2 waveform is not reproducible without its codebase; this module
keeps the reference's I/O CONTRACT (int16 8 kHz speech <-> int16 8 kHz
modem passband, frame-synchronous, text side channel) and implements the
modem as orthogonal-carrier DQPSK:

  * frame = 40 ms = 320 speech samples = 2 modem symbols of 160 samples
  * 160-sample symbols @ 8 kHz make carriers exact 50 Hz DFT bins —
    rectangular-window OFDM, demod is one 160-pt DFT row (matmul-shaped
    batched matmul on device paths; numpy here since speech codecs run
    host-side through the gateway trampoline like the reference's C libs)
  * payload 112 bits/frame: 2 x codec2-2400 subframes (96) + 8-bit sync
    (0xA7) + 8-bit text char -> 56 DQPSK symbols on 28 carriers
    (bins 22..49 = 1100..2450 Hz) x 2 time symbols, differential in time
  * pilot: bin 20 (1000 Hz) BPSK alternating +1/-1 per symbol — timing
    recovery maximizes pilot-bin energy over the 160 candidate offsets,
    frame parity resolved by the sync byte

QA: tests/test_freedv.py — bit-exact payload loopback through the modem,
speech round-trip spectral fidelity, text channel recovery, and offset/
gain robustness.
"""
from __future__ import annotations

import numpy as np

_FS = 8000
_NSYM = 160                 # samples per modem symbol (50 baud)
_SYM_PER_FRAME = 2
_N = _NSYM * _SYM_PER_FRAME  # 320 speech/modem samples per 40 ms frame
_PILOT_BIN = 20             # 1000 Hz
_DATA_BINS = np.arange(22, 50)   # 28 carriers, 1100..2450 Hz
_NC = len(_DATA_BINS)
_SYNC_BYTE = 0xA7
_BITS_PER_FRAME = 112       # 96 codec + 8 sync + 8 text
_AMP = 3000.0               # per-carrier int16 amplitude

_QPSK = np.exp(1j * np.pi / 4 * np.array([1, 3, 7, 5]))  # gray 00,01,10,11


def n_nom_modem_samples(mode=1600) -> int:
    return _N


def n_speech_samples(mode=1600) -> int:
    return _N


def _bits_to_qpsk(bits):
    """(2k,) 0/1 -> (k,) gray-coded QPSK points."""
    b = np.asarray(bits).reshape(-1, 2)
    return _QPSK[b[:, 0] * 2 + b[:, 1]]


def _qpsk_to_bits(pts):
    ang = np.angle(pts * np.exp(-1j * np.pi / 4))
    idx = np.round(ang / (np.pi / 2)).astype(int) % 4
    # inverse of gray map: index in _QPSK order of angle steps 0,1,2,3 ->
    # which (b0,b1) produced it
    inv = {0: (0, 0), 1: (0, 1), 3: (1, 0), 2: (1, 1)}
    out = np.empty((len(idx), 2), np.int8)
    for k, i in enumerate(idx):
        out[k] = inv[i]
    return out.reshape(-1)


class FreeDVTx:
    """Frame-synchronous modulator: 320 int16 speech -> 320 int16 modem."""

    def __init__(self, mode=1600, msg_txt="GNU Radio JAX"):
        from .codec2_native import Codec2
        self.c2 = Codec2(2400)
        self.msg = (msg_txt or " ") + "\r"   # CR-terminated like the ref
        self._msg_pos = 0
        # differential phase memory per data carrier + pilot sign
        self._ph = np.ones(_NC, np.complex128)
        self._pilot_sign = 1.0

    def _next_char(self) -> int:
        c = self.msg[self._msg_pos]
        self._msg_pos = (self._msg_pos + 1) % len(self.msg)
        return ord(c) & 0xFF

    def modulate_frame(self, speech: np.ndarray) -> np.ndarray:
        assert len(speech) == _N
        bits = np.concatenate([
            self.c2.encode_bits(np.asarray(speech[:_NSYM], np.int16)),
            self.c2.encode_bits(np.asarray(speech[_NSYM:], np.int16)),
            np.unpackbits(np.array([_SYNC_BYTE], np.uint8)).astype(np.int8),
            np.unpackbits(np.array([self._next_char()],
                                   np.uint8)).astype(np.int8),
        ])
        assert len(bits) == _BITS_PER_FRAME
        syms = _bits_to_qpsk(bits).reshape(_SYM_PER_FRAME, _NC)
        out = np.empty(_N, np.float64)
        t = np.arange(_NSYM)
        for s in range(_SYM_PER_FRAME):
            self._ph = self._ph * syms[s]          # differential encode
            wave = np.zeros(_NSYM, np.float64)
            for c, b in enumerate(_DATA_BINS):
                wave += np.real(self._ph[c]
                                * np.exp(2j * np.pi * b * t / _NSYM))
            wave += self._pilot_sign * np.cos(2 * np.pi * _PILOT_BIN
                                              * t / _NSYM)
            self._pilot_sign = -self._pilot_sign
            out[s * _NSYM:(s + 1) * _NSYM] = wave
        return np.clip(out * (_AMP / (_NC + 1)) * 2.0,
                       -32767, 32767).astype(np.int16)

    def __call__(self, speech: np.ndarray) -> np.ndarray:
        speech = np.asarray(speech, np.int16).reshape(-1, _N)
        return np.concatenate([self.modulate_frame(f) for f in speech])


class FreeDVRx:
    """Frame-synchronous demodulator with timing + frame-parity sync."""

    def __init__(self, mode=1600):
        from .codec2_native import Codec2
        self.c2 = Codec2(2400)
        self._buf = np.zeros(0, np.float64)
        self._ph = None            # previous symbol's carrier phases
        self._offset = None
        self.text = ""
        self._frames = 0
        self._bad = 0              # consecutive sync-byte failures

    def _dft_row(self, seg, bins):
        t = np.arange(_NSYM)
        E = np.exp(-2j * np.pi * np.outer(bins, t) / _NSYM)
        return E @ seg / _NSYM

    def _acquire(self, x):
        """Timing by ORTHOGONALITY SHARPNESS: at the true symbol offset
        every carrier sits exactly on a 50 Hz DFT bin and the off-grid
        bins are empty; any misalignment leaks energy off-grid. The
        metric on-grid/(off-grid+eps) peaks unambiguously — unlike pilot
        templates, whose autocorrelation sidelobes (carrier phase flip
        compensating the frame sign flip, measured peaking at s=148 on a
        clean loopback) fooled the earlier designs. Frame parity comes
        from the pilot sign (+ on frame-start symbols), sync-byte slip
        remains as fallback for phase-inverting channels."""
        on_bins = np.concatenate([[_PILOT_BIN], _DATA_BINS])
        off_bins = np.array([b for b in range(2, 80)
                             if b not in set(on_bins.tolist())])
        best, best_m = 0, -1.0
        for s in range(_NSYM):
            seg = x[s: s + _NSYM]
            if len(seg) < _NSYM:
                break
            on = np.sum(np.abs(self._dft_row(seg, on_bins)) ** 2)
            off = np.sum(np.abs(self._dft_row(seg, off_bins)) ** 2)
            m = on / (off + 1e-9)
            if m > best_m:
                best_m, best = m, s
        # parity: frame-start symbols carry a pilot-positive sign
        pil = self._dft_row(x[best: best + _NSYM], [_PILOT_BIN])[0]
        if np.real(pil) < 0:
            best += _NSYM
        return best

    def demodulate(self, modem: np.ndarray):
        """Consume modem int16 samples; return (speech int16, n_frames)."""
        x = np.concatenate([self._buf, np.asarray(modem, np.float64)])
        if self._offset is None and len(x) >= 3 * _N:
            # +_NSYM: the generic loop below takes its phase reference
            # from the first symbol and decodes from the second — starting
            # one symbol into frame 0 makes that reference f0.sym1 and the
            # first decode exactly frame 1 (parity-correct by template)
            self._offset = self._acquire(x) + _NSYM
        if self._offset is None:
            self._buf = x
            return np.zeros(0, np.int16)
        x = x[self._offset:]
        self._offset = 0
        out = []
        pos = 0
        # need one symbol of phase reference before the first frame
        if self._ph is None:
            if len(x) < _NSYM:
                self._buf = x
                return np.zeros(0, np.int16)
            self._ph = self._dft_row(x[:_NSYM], _DATA_BINS)
            pos = _NSYM
        while pos + _N <= len(x):
            syms = []
            ok_bits = []
            ph = self._ph
            for s in range(_SYM_PER_FRAME):
                cur = self._dft_row(x[pos + s * _NSYM: pos + (s + 1) * _NSYM],
                                    _DATA_BINS)
                d = cur * np.conj(ph)
                ph = cur
                syms.append(d / np.maximum(np.abs(d), 1e-12))
            bits = _qpsk_to_bits(np.concatenate(syms))
            sync = np.packbits(bits[96:104].astype(np.uint8))[0]
            if sync != _SYNC_BYTE and self._frames == 0:
                # wrong frame parity: slip one symbol and retry once
                self._ph = self._dft_row(x[pos: pos + _NSYM], _DATA_BINS)
                pos += _NSYM
                continue
            if sync != _SYNC_BYTE:
                # Continuous sync tracking (the reference freedv modem
                # re-acquires after losing sync; a sample slip or dropout
                # would otherwise desynchronize this stream permanently —
                # advisor r3). One or two bad sync bytes may just be bit
                # errors; 3 consecutive means we lost the frame grid.
                self._bad += 1
                if self._bad >= 3:
                    self._bad = 0
                    self._offset = None
                    self._ph = None
                    self._buf = x[pos:]
                    if out:
                        return np.concatenate(out).astype(np.int16)
                    return np.zeros(0, np.int16)
            else:
                self._bad = 0
            self._ph = ph
            ch = chr(np.packbits(bits[104:112].astype(np.uint8))[0])
            if ch != "\r":
                self.text += ch
            sp1 = self.c2.decode_bits(bits[:48])
            sp2 = self.c2.decode_bits(bits[48:96])
            out.append(np.concatenate([sp1, sp2]))
            self._frames += 1
            pos += _N
        self._buf = x[pos:]
        if out:
            return np.concatenate(out).astype(np.int16)
        return np.zeros(0, np.int16)

    def __call__(self, modem: np.ndarray) -> np.ndarray:
        return self.demodulate(modem)
