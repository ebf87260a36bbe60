"""DVB-T2 frame assembly: L1 signalling + frame mapper, full frequency
interleaver (P2/data/FC symbol sizes), pilot generator + OFDM modulator,
MISO processing, PAPR tone reservation, and P1 insertion (ETSI EN 302 755
secs 7-9).

Reference behavior (reimplemented, NOT copied):
  gr-dtv/lib/dvbt2/dvbt2_framemapper_cc_impl.cc — L1-pre/L1-post field
      packing + CRC32, shortened BCH (12-poly short-frame generator),
      shortened+punctured LDPC 1/4S / 1/2S, L1 bit interleave + demux
      modulation, and the zigzag distribution of L1+data cells over N_P2
      P2 symbols (general_work at :1662-1753).
  gr-dtv/lib/dvbt2/dvbt2_freqinterleaver_cc_impl.cc — per-symbol-type H
      permutations (C_P2 / C_DATA / N_FC filters of one LFSR stream), odd
      parity alternation, and the 32K even=inverse(odd) rule (:731-747).
  gr-dtv/lib/dvbt2/dvbt2_pilotgenerator_cc_impl.cc — P2/scattered/
      continual/edge pilot carrier maps, PRBS x^11+x^2+1 pilot modulation
      XOR the frame-level PN sequence, per-fft amplitudes, carrier-to-FFT
      mapping with left/right nulls, and the final IFFT with
      5/sqrt(27*C_PS) normalization (:684-1145, :2620-2716).
  gr-dtv/lib/dvbt2/dvbt2_miso_cc_impl.cc — Alamouti-style pair encoding
      (group 2 output: -conj(c2), conj(c1)) (:556-576).
  gr-dtv/lib/dvbt2/dvbt2_paprtr_cc_impl.cc — iterative tone-reservation
      peak cancellation with reserved-carrier amplitude limiting
      (:676-846).
  gr-dtv/lib/dvbt2/dvbt2_p1insertion_cc_impl.cc — C-A-B P1 preamble
      prepended per T2 frame (:210-279).

Design: every interleaver/mapper stage is a host-precomputed index
vector applied as ONE gather/scatter on device, so XLA fuses the whole
frame assembly (frame map -> freq interleave -> pilot scatter) into a
couple of kernels in front of a single batched IFFT over all symbols of
all frames; PAPR iteration is a vmapped lax.while_loop over symbols.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from . import dvbs2
from .dvbt2 import t2_constellation, _FREQ_PARAMS
from .dvb_ldpc_tables import TABLES
from . import dvbt2_frame_tables as T

# enum codings follow gr-dtv/include/gnuradio/dtv/dvbt2_config.h and
# dvb_config.h (needed verbatim for L1 signalling bit fields)
FFT_CODE = {"2K": 0, "8K": 1, "4K": 2, "1K": 3, "16K": 4, "32K": 5}
GI_CODE = {"1/32": 0, "1/16": 1, "1/8": 2, "1/4": 3, "1/128": 4,
           "19/128": 5, "19/256": 6}
GI_FRAC = {"1/32": (1, 32), "1/16": (1, 16), "1/8": (1, 8), "1/4": (1, 4),
           "1/128": (1, 128), "19/128": (19, 128), "19/256": (19, 256)}
PP_CODE = {f"PP{i}": i - 1 for i in range(1, 9)}
L1MOD_CODE = {"bpsk": 0, "qpsk": 1, "16qam": 2, "64qam": 3}
L1MOD_BITS = {"bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6}
MOD_CODE = {"qpsk": 0, "16qam": 1, "64qam": 2, "256qam": 3}
VERSION_CODE = {"1.1.1": 0, "1.2.1": 1, "1.3.1": 2}
PREAMBLE_CODE = {"T2_SISO": 0, "T2_MISO": 1, "NON_T2": 2,
                 "T2_LITE_SISO": 3, "T2_LITE_MISO": 4}
RATE_PLP_COD = {"1/3": 6, "2/5": 7, "1/2": 0, "3/5": 1, "2/3": 2,
                "3/4": 3, "4/5": 4, "5/6": 5}
BW_FS = {"1.7MHz": 131e6 / 71.0, "5MHz": 5e6 * 8 / 7, "6MHz": 6e6 * 8 / 7,
         "7MHz": 7e6 * 8 / 7, "8MHz": 8e6 * 8 / 7, "10MHz": 10e6 * 8 / 7}

KSIG_PRE, KSIG_POST = 200, 350
KBCH_1_4, NBCH_1_4 = 3072, 3240
KBCH_1_2, NBCH_1_2 = 7032, 7200
NBCH_PARITY = 168
FRAME_SHORT = 16200

# (fft_len, C_PS normal, C_PS ext, K_EXT ext, K_OFFSET normal)
FFT_PARAMS = {
    "1K": (1024, 853, 853, 0, 0),
    "2K": (2048, 1705, 1705, 0, 0),
    "4K": (4096, 3409, 3409, 0, 0),
    "8K": (8192, 6817, 6913, 48, 48),
    "16K": (16384, 13633, 13921, 144, 144),
    "32K": (32768, 27265, 27841, 288, 288),
}
# fft -> (N_P2, C_P2 siso, C_P2 miso)
P2_PARAMS = {
    "1K": (16, 558, 546), "2K": (8, 1118, 1098), "4K": (4, 2236, 2198),
    "8K": (2, 4472, 4398), "16K": (1, 8944, 8814), "32K": (1, 22432, 17612),
}
# (fft, pp, 'norm'|'ext') -> (C_DATA, N_FC, C_FC); EN 302 755 tables 47-57
CELL_TABLE = {}
_ct = {
    "1K": {1: (764, 568, 402), 2: (768, 710, 654), 3: (798, 710, 490),
           4: (804, 780, 707), 5: (818, 780, 544)},
    "2K": {1: (1522, 1136, 804), 2: (1532, 1420, 1309), 3: (1596, 1420, 980),
           4: (1602, 1562, 1415), 5: (1632, 1562, 1088),
           7: (1646, 1632, 1396)},
    "4K": {1: (3084, 2272, 1609), 2: (3092, 2840, 2619),
           3: (3228, 2840, 1961), 4: (3234, 3124, 2831),
           5: (3298, 3124, 2177), 7: (3328, 3266, 2792)},
}
for _f, _d in _ct.items():
    for _p in range(1, 9):
        CELL_TABLE[(_f, _p, "norm")] = _d.get(_p, (0, 0, 0))
        CELL_TABLE[(_f, _p, "ext")] = _d.get(_p, (0, 0, 0))
_ct8n = {1: (6208, 4544, 3218), 2: (6214, 5680, 5238), 3: (6494, 5680, 3922),
         4: (6498, 6248, 5662), 5: (6634, 6248, 4354), 7: (6698, 6532, 5585),
         8: (6698, 0, 0)}
_ct8e = {1: (6296, 4608, 3264), 2: (6298, 5760, 5312), 3: (6584, 5760, 3978),
         4: (6588, 6336, 5742), 5: (6728, 6336, 4416), 7: (6788, 6624, 5664),
         8: (6788, 0, 0)}
_ct16n = {1: (12418, 9088, 6437), 2: (12436, 11360, 10476),
          3: (12988, 11360, 7845), 4: (13002, 12496, 11324),
          5: (13272, 12496, 8709), 6: (13288, 13064, 11801),
          7: (13416, 13064, 11170), 8: (13406, 0, 0)}
_ct16e = {1: (12678, 9280, 6573), 2: (12698, 11600, 10697),
          3: (13262, 11600, 8011), 4: (13276, 12760, 11563),
          5: (13552, 12760, 8893), 6: (13568, 13340, 12051),
          7: (13698, 13340, 11406), 8: (13688, 0, 0)}
_ct32n = {2: (24886, 22720, 20952), 4: (26022, 24992, 22649),
          6: (26592, 26128, 23603), 7: (26836, 0, 0), 8: (26812, 0, 0)}
_ct32e = {2: (25412, 23200, 21395), 4: (26572, 25520, 23127),
          6: (27152, 26680, 24102), 7: (27404, 0, 0), 8: (27376, 0, 0)}
for _p in range(1, 9):
    CELL_TABLE[("8K", _p, "norm")] = _ct8n.get(_p, (0, 0, 0))
    CELL_TABLE[("8K", _p, "ext")] = _ct8e.get(_p, (0, 0, 0))
    CELL_TABLE[("16K", _p, "norm")] = _ct16n.get(_p, (0, 0, 0))
    CELL_TABLE[("16K", _p, "ext")] = _ct16e.get(_p, (0, 0, 0))
    CELL_TABLE[("32K", _p, "norm")] = _ct32n.get(_p, (0, 0, 0))
    CELL_TABLE[("32K", _p, "ext")] = _ct32e.get(_p, (0, 0, 0))
PAPR_RESERVED = {"1K": 10, "2K": 18, "4K": 36, "8K": 72, "16K": 144,
                 "32K": 288}
CELL_SIZE = {("normal", "qpsk"): 32400, ("normal", "16qam"): 16200,
             ("normal", "64qam"): 10800, ("normal", "256qam"): 8100,
             ("short", "qpsk"): 8100, ("short", "16qam"): 4050,
             ("short", "64qam"): 2700, ("short", "256qam"): 2025}
# pp -> (dx, dy); sp amplitude numerator/denominator per pp
PP_DXDY = {1: (3, 4), 2: (6, 2), 3: (6, 4), 4: (12, 2), 5: (12, 4),
           6: (24, 2), 7: (24, 4), 8: (6, 16)}
SP_AMP = {1: 4 / 3, 2: 4 / 3, 3: 7 / 4, 4: 7 / 4, 5: 7 / 3, 6: 7 / 3,
          7: 7 / 3, 8: 7 / 3}
CP_AMP = {"1K": 4 / 3, "2K": 4 / 3, "4K": 4 * np.sqrt(2.0) / 3,
          "8K": 8 / 3, "16K": 8 / 3, "32K": 8 / 3}
CP_MOD = {"1K": 1632, "2K": 1632, "4K": 3264, "8K": 6528, "16K": 13056,
          "32K": 0}
CP_NGROUPS = {"1K": 1, "2K": 2, "4K": 3, "8K": 4, "16K": 5, "32K": 6}
P2_PAPR = {"1K": T.P2_PAPR_MAP_1K, "2K": T.P2_PAPR_MAP_2K,
           "4K": T.P2_PAPR_MAP_4K, "8K": T.P2_PAPR_MAP_8K,
           "16K": T.P2_PAPR_MAP_16K, "32K": T.P2_PAPR_MAP_32K}
TR_PAPR = {"1K": T.TR_PAPR_MAP_1K, "2K": T.TR_PAPR_MAP_2K,
           "4K": T.TR_PAPR_MAP_4K, "8K": T.TR_PAPR_MAP_8K,
           "16K": T.TR_PAPR_MAP_16K, "32K": T.TR_PAPR_MAP_32K}

# carrier-map codes
DATA, P2P, P2P_INV, P2PAPR, SP, SP_INV, CP, CP_INV, TRPAPR = range(9)


class T2Params:
    """Hashable config for the OFDM side of the T2 chain (framemapper
    through p1insertion). String arguments mirror the reference block
    parameters; all derived sizes come out as attributes."""

    def __init__(self, fftsize="4K", guardinterval="1/32",
                 pilotpattern="PP7", carriermode="normal",
                 preamble="T2_SISO", misogroup=1, paprmode="off",
                 version="1.1.1", l1constellation="16qam",
                 l1scrambled=False, reservedbiasbits=False,
                 inputmode="normal", inband=False, t2frames=2,
                 numdatasyms=100, fecblocks=31, tiblocks=3,
                 framesize="normal", rate="2/3", constellation="64qam",
                 rotation=True, bandwidth="8MHz", vclip=3.3,
                 papr_iterations=3, equalization=False):
        self.fftsize = fftsize
        self.guardinterval = guardinterval
        self.pilotpattern = pilotpattern
        self.pp = int(pilotpattern.replace("PP", ""))
        self.carriermode = carriermode
        self.preamble = preamble
        self.miso = preamble in ("T2_MISO", "T2_LITE_MISO")
        self.misogroup = int(misogroup)          # 1 = TX1, 2 = TX2
        self.paprmode = paprmode                 # off | ace | tr | both
        self.version = version
        self.l1constellation = l1constellation
        self.l1scrambled = bool(l1scrambled) and version == "1.3.1"
        self.reservedbiasbits = bool(reservedbiasbits) and version == "1.3.1"
        self.inputmode = inputmode
        self.inband = bool(inband) and version == "1.3.1"
        self.t2frames = int(t2frames)
        self.numdatasyms = int(numdatasyms)
        self.fecblocks = int(fecblocks)
        self.tiblocks = int(tiblocks)
        self.framesize = framesize
        self.rate = rate
        self.constellation = constellation
        self.rotation = bool(rotation)
        self.bandwidth = bandwidth
        self.vclip = float(vclip)
        self.papr_iterations = int(papr_iterations)
        self.equalization = bool(equalization)

        fft_len, cps_n, cps_e, k_ext, k_off = FFT_PARAMS[fftsize]
        ext = carriermode == "extended"
        self.fft_len = fft_len
        self.C_PS = cps_e if ext else cps_n
        self.K_EXT = k_ext if ext else 0
        self.K_OFFSET = 0 if ext else k_off
        n_p2, c_p2_s, c_p2_m = P2_PARAMS[fftsize]
        self.N_P2 = n_p2
        self.C_P2 = c_p2_m if self.miso else c_p2_s
        cd, nfc, cfc = CELL_TABLE[(fftsize, self.pp, "ext" if ext
                                   else "norm")]
        if paprmode in ("tr", "both"):
            res = PAPR_RESERVED[fftsize]
            cd = cd - res if cd else 0
            nfc = nfc - res if nfc else 0
            cfc = cfc - res if cfc else 0
        if not self.miso:
            # SISO GI/PP combinations without a frame-closing symbol
            if (guardinterval, self.pp) in (("1/128", 7), ("1/32", 4),
                                            ("1/16", 2), ("19/256", 2)):
                nfc = cfc = 0
        self.C_DATA, self.N_FC, self.C_FC = cd, nfc, cfc
        if cd == 0:
            raise ValueError(
                f"unsupported T2 combination {fftsize}/{pilotpattern}")
        self.L_FC = 1 if nfc else 0
        self.num_symbols = self.numdatasyms + self.N_P2
        if nfc == 0:
            self.mapped_items = n_p2 * self.C_P2 + self.numdatasyms * cd
        else:
            self.mapped_items = (n_p2 * self.C_P2
                                 + (self.numdatasyms - 1) * cd + nfc)
        self.cell_size = CELL_SIZE[(framesize, constellation)]
        self.stream_items = self.cell_size * self.fecblocks
        self.active_items = self.mapped_items
        num, den = GI_FRAC[guardinterval]
        self.gi_len = fft_len * num // den
        self.frame_items = self.num_symbols * (fft_len + self.gi_len)
        self.dx, self.dy = PP_DXDY[self.pp]

        # L1-post sizing (framemapper :860-869)
        eta = L1MOD_BITS[l1constellation]
        self.eta_mod = eta
        n_punc_temp = (6 * (KBCH_1_2 - KSIG_POST)) // 5
        n_post_temp = KSIG_POST + NBCH_PARITY + 9000 - n_punc_temp
        if n_p2 == 1:
            n_post = int(np.ceil(n_post_temp / (2 * eta))) * 2 * eta
        else:
            n_post = int(np.ceil(n_post_temp / (eta * n_p2))) * eta * n_p2
        self.N_post = n_post
        self.N_punc = n_punc_temp - (n_post - n_post_temp)
        self.n_l1post_cells = n_post // eta
        dummy = (self.mapped_items - self.stream_items - 1840
                 - self.n_l1post_cells - (nfc - cfc))
        if dummy < 0:
            raise ValueError("too many FEC blocks in T2 frame")
        self.n_dummy = dummy
        self.s1 = PREAMBLE_CODE[preamble]
        self.s2_fft = FFT_CODE[fftsize]

    def key(self):
        return (self.fftsize, self.guardinterval, self.pp, self.carriermode,
                self.preamble, self.misogroup, self.paprmode, self.version,
                self.l1constellation, self.l1scrambled,
                self.reservedbiasbits, self.inputmode, self.inband,
                self.t2frames, self.numdatasyms, self.fecblocks,
                self.tiblocks, self.framesize, self.rate,
                self.constellation, self.rotation, self.bandwidth,
                self.vclip, self.papr_iterations, self.equalization)

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, T2Params) and self.key() == other.key()


# ---------------------------------------------------------------------------
# PRBS / PN sequences
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _pilot_prbs() -> np.ndarray:
    """x^11 + x^2 + 1 PRBS, seed all-ones (pilotgenerator init_prbs)."""
    sr = 0x7FF
    out = np.zeros(27841, np.int64)
    for i in range(27841):
        b = (sr ^ (sr >> 2)) & 1
        out[i] = sr & 1
        sr >>= 1
        if b:
            sr |= 0x400
    return out


@lru_cache(maxsize=1)
def _pn_sequence() -> np.ndarray:
    bits = []
    for byte in T.PN_SEQUENCE_TABLE:
        bits += [(byte >> k) & 1 for k in range(7, -1, -1)]
    return np.array(bits, np.int64)


def _prbs_0x4a80(n: int) -> np.ndarray:
    """x^15+x^14+1 scrambler bits, seed 0x4A80 (framemapper
    init_dummy_randomizer / init_l1_randomizer)."""
    sr = 0x4A80
    out = np.zeros(n, np.int64)
    for i in range(n):
        b = (sr ^ (sr >> 1)) & 1
        out[i] = b
        sr >>= 1
        if b:
            sr |= 0x4000
    return out


# ---------------------------------------------------------------------------
# L1 signalling
# ---------------------------------------------------------------------------

def _bits(value: int, width: int) -> list:
    return [(int(value) >> k) & 1 for k in range(width - 1, -1, -1)]


def _crc32_bits(bits: np.ndarray) -> np.ndarray:
    """MSB-first CRC-32 (poly 0x04C11DB7, init 0xFFFFFFFF, no final xor)."""
    crc = 0xFFFFFFFF
    for b in bits:
        fb = int(b) ^ ((crc >> 31) & 1)
        crc = (crc << 1) & 0xFFFFFFFF
        if fb:
            crc ^= 0x04C11DB7
    return np.array(_bits(crc, 32), np.int64)


@lru_cache(maxsize=8)
def _short_bch_P(kbch: int) -> np.ndarray:
    """Remainder matrix for the 168-parity short-frame BCH (the same
    12-minimal-poly generator the data path uses; dvbs2.bch_generator)."""
    g = dvbs2.bch_generator("short", 12)
    npar = g.size - 1
    assert npar == NBCH_PARITY
    P = np.zeros((kbch, npar), np.int8)
    r = g[:npar].copy()
    P[kbch - 1] = r
    for i in range(kbch - 2, -1, -1):
        carry = r[npar - 1]
        r = np.roll(r, 1)
        r[0] = 0
        if carry:
            r ^= g[:npar]
            r &= 1
        P[i] = r
    return P[:, ::-1].copy()


def _short_ldpc_parity(info: np.ndarray, table_key: str, q: int,
                       nbch: int) -> np.ndarray:
    """IRA parity (length 16200-nbch) for the L1 LDPC codes."""
    pbits = FRAME_SHORT - nbch
    acc = np.zeros(pbits, np.int64)
    for r, row in enumerate(TABLES[table_key]):
        for x in row:
            idx = (x + np.arange(360) * q) % pbits
            np.add.at(acc, idx, info[r * 360 + np.arange(360)])
    parity = np.cumsum(acc & 1) & 1
    return parity


def _l1_constellation_points(kind: str) -> np.ndarray:
    if kind == "bpsk":
        return np.array([1.0, -1.0], np.complex64)
    return t2_constellation(kind, False)


@lru_cache(maxsize=32)
def l1pre_cells(p: T2Params) -> np.ndarray:
    """1840 BPSK cells of L1-pre signalling (constant per config)."""
    f = []
    f += _bits(0, 8)                      # type = STREAMTYPE_TS
    f += [1 if p.carriermode == "extended" else 0]
    f += _bits(p.s1, 3)
    f += _bits(p.s2_fft & 0x7, 3)
    f += [0]                              # S2 field bit 0 (mixed = no)
    f += [0]                              # l1_repetition_flag
    f += _bits(GI_CODE[p.guardinterval], 3)
    f += _bits({"off": 0, "ace": 1, "tr": 2, "both": 3}[p.paprmode], 4)
    f += _bits(L1MOD_CODE[p.l1constellation], 4)
    f += _bits(0, 2)                      # l1_cod
    f += _bits(0, 2)                      # l1_fec_type
    f += _bits(p.n_l1post_cells, 18)      # l1_post_size (cells)
    f += _bits(KSIG_POST - 32, 18)        # l1_post_info_size
    f += _bits(PP_CODE[p.pilotpattern], 4)
    f += _bits(0, 8)                      # tx_id_availability
    f += _bits(0, 16)                     # cell_id
    f += _bits(0x3085, 16)                # network_id
    f += _bits(0x8001, 16)                # t2_system_id
    f += _bits(p.t2frames, 8)
    f += _bits(p.numdatasyms, 12)
    f += _bits(0, 3)                      # regen_flag
    f += [0]                              # l1_post_extension
    f += _bits(1, 3)                      # num_rf
    f += _bits(0, 3)                      # current_rf_index
    f += _bits(VERSION_CODE[p.version], 4)
    f += [1 if p.l1scrambled else 0]
    f += [0]                              # t2_base_lite
    f += _bits(0xF if p.reservedbiasbits else 0, 4)
    bits = np.array(f, np.int64)
    assert bits.size == KSIG_PRE - 32
    bits = np.concatenate([bits, _crc32_bits(bits)])
    info = np.zeros(KBCH_1_4, np.int64)
    info[:KSIG_PRE] = bits
    parity_bch = (info @ _short_bch_P(KBCH_1_4)) & 1
    codeword_info = np.concatenate([info, parity_bch])
    parity = _short_ldpc_parity(codeword_info, "1_4S", 36, NBCH_1_4)
    # puncture (framemapper :1237-1248): groups of stride 36
    punct = np.zeros(parity.size, bool)
    for g in T.PRE_PUNCTURE[:31]:
        punct[np.arange(360) * 36 + g] = True
    punct[np.arange(328) * 36 + T.PRE_PUNCTURE[31]] = True
    tx_bits = np.concatenate([bits, parity_bch, parity[~punct]])
    assert tx_bits.size == 1840
    return (1.0 - 2.0 * tx_bits).astype(np.complex64)


@lru_cache(maxsize=64)
def _l1post_padding_map(p: T2Params) -> np.ndarray:
    """bool[KBCH_1_2]: True where padded (framemapper :1443-1470)."""
    pad_tab = {"bpsk": T.POST_PADDING_BQPSK, "qpsk": T.POST_PADDING_BQPSK,
               "16qam": T.POST_PADDING_16QAM,
               "64qam": T.POST_PADDING_64QAM}[p.l1constellation]
    offset_bits = KSIG_POST
    pad = np.zeros(KBCH_1_2, bool)
    if offset_bits <= 360:
        m = 19
        last = 360 - offset_bits
    else:
        m = (KBCH_1_2 - offset_bits) // 360
        last = KBCH_1_2 - offset_bits - 360 * m
    for n in range(m):
        g = pad_tab[n]
        glen = 192 if g == 19 else 360
        pad[g * 360:g * 360 + glen] = True
    g = pad_tab[m]
    glen = 192 if g == 19 else 360
    pad[g * 360 + glen - last:g * 360 + glen] = True
    return pad


def l1post_cells(p: T2Params, frame_idx: int) -> np.ndarray:
    """N_post/eta cells of L1-post for one T2 frame index."""
    lp = []
    lp += _bits(1, 15)                    # sub_slices_per_frame
    lp += _bits(1, 8)                     # num_plp
    lp += _bits(0, 4) + _bits(0, 8)       # num_aux, aux_config_rfu
    lp += _bits(0, 3)                     # rf_idx
    lp += _bits(729833333, 32)            # frequency
    lp += _bits(0, 8)                     # plp_id
    lp += _bits(1, 3)                     # plp_type
    lp += _bits(3, 5)                     # plp_payload_type
    lp += [0]                             # ff_flag
    lp += _bits(0, 3)                     # first_rf_idx
    lp += _bits(0, 8)                     # first_frame_idx
    lp += _bits(1, 8)                     # plp_group_id
    lp += _bits(RATE_PLP_COD[p.rate], 3)
    lp += _bits(MOD_CODE[p.constellation], 3)
    lp += [1 if p.rotation else 0]
    lp += _bits(1 if p.framesize == "normal" else 0, 2)   # plp_fec_type
    lp += _bits(p.fecblocks, 10)          # plp_num_blocks_max
    lp += _bits(1, 8)                     # frame_interval
    lp += _bits(p.tiblocks, 8)            # time_il_length
    lp += [0, 0]                          # time_il_type, in_band_a
    lp += [1 if p.inband else 0]          # in_band_b
    lp += _bits(0x7FF if p.reservedbiasbits else 0, 11)
    lp += _bits(0 if p.version == "1.1.1"
                else ({"normal": 0, "hiefficiency": 1}.get(p.inputmode, 0)
                      + 1), 2)            # plp_mode
    lp += [0, 0]                          # static_flag, static_padding
    lp += _bits(0, 2)                     # fef_length_msb
    lp += _bits(0x3FFFFFFF if p.reservedbiasbits else 0, 30)
    lp += _bits(frame_idx, 8)
    lp += _bits(0, 22) + _bits(0, 22)     # sub_slice_interval, type_2_start
    lp += _bits(0, 8) + _bits(0, 3)       # l1_change_counter, start_rf_idx
    lp += _bits(0xFF if p.reservedbiasbits else 0, 8)
    lp += _bits(0, 8)                     # plp_id (dynamic)
    lp += _bits(0, 22)                    # plp_start
    lp += _bits(p.fecblocks, 10)          # plp_num_blocks
    lp += _bits(0xFF if p.reservedbiasbits else 0, 8)
    lp += _bits(0xFF if p.reservedbiasbits else 0, 8)
    bits = np.array(lp, np.int64)
    assert bits.size == KSIG_POST - 32
    bits = np.concatenate([bits, _crc32_bits(bits)])
    if p.l1scrambled:
        bits = bits ^ _prbs_0x4a80(KBCH_1_2)[:KSIG_POST]
    pad = _l1post_padding_map(p)
    info = np.zeros(KBCH_1_2, np.int64)
    info[~pad] = bits
    parity_bch = (info @ _short_bch_P(KBCH_1_2)) & 1
    parity = _short_ldpc_parity(np.concatenate([info, parity_bch]),
                                "1_2S", 25, NBCH_1_2)
    punc_tab = {"bpsk": T.POST_PUNCTURE_BQPSK, "qpsk": T.POST_PUNCTURE_BQPSK,
                "16qam": T.POST_PUNCTURE_16QAM,
                "64qam": T.POST_PUNCTURE_64QAM}[p.l1constellation]
    punct = np.zeros(parity.size, bool)
    nfull = p.N_punc // 360
    for g in punc_tab[:nfull]:
        punct[np.arange(360) * 25 + g] = True
    rem = p.N_punc - nfull * 360
    punct[np.arange(rem) * 25 + punc_tab[nfull]] = True
    stream = np.concatenate([info[~pad], parity_bch, parity[~punct]])
    assert stream.size == p.N_post, (stream.size, p.N_post)
    eta = p.eta_mod
    if p.l1constellation in ("16qam", "64qam"):
        ncols = 2 * eta
        rows = p.N_post // ncols
        # column-major banks read row-wise (framemapper :1556-1574)
        inter = stream.reshape(ncols, rows).T.reshape(-1)
        mux = np.array(T.L1_MUX16 if eta == 4 else T.L1_MUX64, np.int64)
        g = inter.reshape(-1, ncols)       # one group -> 2 cells
        packed = np.zeros(g.shape[0], np.int64)
        for e in range(ncols):
            packed |= g[:, mux[e]] << (ncols - 1 - e)
        lut = _l1_constellation_points(p.l1constellation)
        hi = lut[packed >> eta]
        lo = lut[packed & ((1 << eta) - 1)]
        return np.stack([hi, lo], axis=1).reshape(-1).astype(np.complex64)
    if p.l1constellation == "qpsk":
        g = stream.reshape(-1, 2)
        idx = (g[:, 0] << 1) | g[:, 1]
        return _l1_constellation_points("qpsk")[idx].astype(np.complex64)
    return (1.0 - 2.0 * stream).astype(np.complex64)


# ---------------------------------------------------------------------------
# frame mapper
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def _frame_map_perm(p: T2Params) -> np.ndarray:
    """src[mapped_items]: output position i takes combined-stream index
    src[i], where combined = [l1pre | l1post | data | dummy | fc-nulls]
    (the reference's zigzag interleave, framemapper :1693-1752)."""
    n_p2, c_p2 = p.N_P2, p.C_P2
    n_l1pre, n_l1post = 1840, p.n_l1post_cells
    src = np.zeros(p.mapped_items, np.int64)
    if n_p2 == 1:
        src[:] = np.arange(p.mapped_items)
        return src.astype(np.int32)
    a = n_l1pre // n_p2
    b = n_l1post // n_p2
    for n in range(n_p2):
        # l1pre round-robin
        src[n * c_p2 + np.arange(a)] = n + np.arange(a) * n_p2
        # l1post round-robin
        src[n * c_p2 + a + np.arange(b)] = n_l1pre + n + np.arange(b) * n_p2
    # sequential fill of the P2 remainders, then the data symbols
    read = n_l1pre + n_l1post
    rem = c_p2 - a - b
    for n in range(n_p2):
        src[n * c_p2 + a + b + np.arange(rem)] = read + np.arange(rem)
        read += rem
    tail = p.mapped_items - n_p2 * c_p2
    src[n_p2 * c_p2:] = read + np.arange(tail)
    return src.astype(np.int32)


@lru_cache(maxsize=32)
def _dummy_cells(p: T2Params) -> np.ndarray:
    bits = _prbs_0x4a80(p.n_dummy)
    return (1.0 - 2.0 * bits).astype(np.complex64)


@lru_cache(maxsize=32)
def _l1post_stack(p: T2Params) -> np.ndarray:
    return np.stack([l1post_cells(p, i) for i in range(p.t2frames)])


def frame_map(cells, p: T2Params, frame_idx0: int = 0):
    """[nf, stream_items] cells -> [nf, mapped_items] frame cells.
    frame_idx0 = T2 frame index of the first frame (cycles mod t2frames)."""
    nf = cells.shape[0]
    l1pre = jnp.asarray(l1pre_cells(p))
    l1post = jnp.asarray(_l1post_stack(p))
    idx = (frame_idx0 + jnp.arange(nf)) % p.t2frames
    dummy = jnp.asarray(_dummy_cells(p))
    nulls = jnp.zeros(p.N_FC - p.C_FC, jnp.complex64)
    combined = jnp.concatenate([
        jnp.tile(l1pre[None], (nf, 1)),
        l1post[idx],
        cells.astype(jnp.complex64),
        jnp.tile(dummy[None], (nf, 1)),
        jnp.tile(nulls[None], (nf, 1)),
    ], axis=1)
    perm = jnp.asarray(_frame_map_perm(p))
    return combined[:, perm]


# ---------------------------------------------------------------------------
# frequency interleaver (P2 / data / FC sizes)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def _freq_perm_frame(p: T2Params) -> np.ndarray:
    """Gather index over a whole frame: out[i] = in[src[i]]."""
    deg, mask, max_states, taps, bpe, bpo = _FREQ_PARAMS[p.fftsize]
    sizes = [p.C_DATA, p.C_P2, p.N_FC]
    hs = {s: ([], []) for s in sizes}
    lfsr = 0
    for i in range(max_states):
        if i < 2:
            lfsr = 0
        elif i == 2:
            lfsr = 1
        else:
            r = 0
            for k in taps:
                r ^= (lfsr >> k) & 1
            lfsr &= mask
            lfsr >>= 1
            lfsr |= r << (deg - 1)
        even = odd = 0
        for n in range(deg):
            bit = (lfsr >> n) & 1
            even |= bit << bpe[n]
            odd |= bit << bpo[n]
        even += (i % 2) * (max_states // 2)
        odd += (i % 2) * (max_states // 2)
        for s in sizes:
            he, ho = hs[s]
            if even < s and len(he) < s:
                he.append(even)
            if odd < s and len(ho) < s:
                ho.append(odd)
    perms = {}
    for s in sizes:
        he = np.array(hs[s][0], np.int64)
        ho = np.array(hs[s][1], np.int64)
        if p.fftsize == "32K" and s > 0:
            # even symbols apply the INVERSE of the odd permutation
            # (freqinterleaver :731-747)
            he = np.argsort(ho)
        perms[s] = (he, ho)
    src = np.zeros(p.mapped_items, np.int64)
    off = 0
    sym = 0
    for j in range(p.N_P2):
        he, ho = perms[p.C_P2]
        h = he if sym % 2 == 0 else ho
        src[off:off + p.C_P2] = off + h
        off += p.C_P2
        sym += 1
    ndata = p.numdatasyms - p.L_FC
    for j in range(ndata):
        he, ho = perms[p.C_DATA]
        h = he if sym % 2 == 0 else ho
        src[off:off + p.C_DATA] = off + h
        off += p.C_DATA
        sym += 1
    if p.L_FC:
        he, ho = perms[p.N_FC]
        h = he if sym % 2 == 0 else ho
        src[off:off + p.N_FC] = off + h
        off += p.N_FC
    assert off == p.mapped_items
    return src.astype(np.int32)


def freq_interleave_frame(mapped, p: T2Params):
    """[nf, mapped_items] -> frequency-interleaved, all symbol types."""
    return mapped[:, jnp.asarray(_freq_perm_frame(p))]


def freq_deinterleave_frame(interleaved, p: T2Params):
    inv = np.argsort(_freq_perm_frame(p)).astype(np.int32)
    return interleaved[:, jnp.asarray(inv)]


# ---------------------------------------------------------------------------
# pilot generator + OFDM modulator
# ---------------------------------------------------------------------------

def _apply_tx2_inversion(code_plain, code_inv, pos, dx, tx2):
    return code_inv if (tx2 and (pos // dx) % 2 and pos % dx == 0) \
        else code_plain


@lru_cache(maxsize=16)
def _carrier_maps(p: T2Params):
    """(p2_map, fc_map, data_maps[num_symbols]) int8 code arrays [C_PS].
    Faithful port of pilotgenerator :684-1075 and init_pilots."""
    C_PS, K_EXT = p.C_PS, p.K_EXT
    tx2 = p.miso and p.misogroup == 2
    fft = p.fftsize

    p2 = np.full(C_PS, DATA, np.int8)
    step = 6 if (fft == "32K" and not p.miso) else 3
    for i in range(0, C_PS, step):
        p2[i] = P2P_INV if (tx2 and (i // 3) % 2 and i % 3 == 0) else P2P
    if p.carriermode == "extended":
        for i in range(K_EXT):
            for pos in (i, i + C_PS - K_EXT):
                p2[pos] = P2P_INV if (tx2 and (pos // 3) % 2
                                      and pos % 3 == 0) else P2P
    if p.miso:
        p2[K_EXT + 1] = p2[K_EXT + 2] = P2P
        p2[C_PS - K_EXT - 2] = p2[C_PS - K_EXT - 3] = P2P
    p2_papr = np.array(P2_PAPR[fft], np.int64) + K_EXT
    p2[p2_papr] = P2PAPR
    if p.miso:
        # re-pilot neighbors of PAPR holes so P2 pilot density survives
        for i, ki in enumerate(p2_papr):
            nxt = p2_papr[i + 1] if i + 1 < p2_papr.size else -99
            prv = p2_papr[i - 1] if i > 0 else -99
            if ki % 3 == 1 and ki + 1 != nxt:
                p2[ki + 1] = P2P
            if ki % 3 == 2 and ki - 1 != prv:
                p2[ki - 1] = P2P

    dx, dy = p.dx, p.dy
    fc = np.full(C_PS, DATA, np.int8)
    for i in range(0, C_PS, dx):
        fc[i] = SP_INV if (tx2 and (i // dx) % 2) else SP
    if (fft, p.pp) in (("1K", 4), ("1K", 5), ("2K", 7)):
        fc[C_PS - 2] = SP
    if tx2 and (p.numdatasyms + p.N_P2 - 1) % 2:
        fc[0] = fc[C_PS - 1] = SP_INV
    else:
        fc[0] = fc[C_PS - 1] = SP
    if p.paprmode in ("tr", "both"):
        fc[p2_papr] = TRPAPR

    # continual pilot set: CP groups 1..K(fft) (mod per fft) + extended
    # extras. TX2 inversion per the spec rule (k mod dx == 0 parity).
    cps = []
    mod = CP_MOD[fft]
    for g in range(1, CP_NGROUPS[fft] + 1):
        vals = T.CP_GROUPS[str(p.pp)].get(str(g))
        if vals:
            v = np.array(vals, np.int64)
            cps.append(v % mod if mod else v)
    key = f"{p.pp}_{fft}"
    if p.carriermode == "extended" and key in T.CP_EXTENDED_EXTRAS:
        cps.append(np.array(T.CP_EXTENDED_EXTRAS[key], np.int64))
    cp_pos = np.concatenate(cps) if cps else np.zeros(0, np.int64)

    data_maps = np.full((p.num_symbols, C_PS), DATA, np.int8)
    for sym in range(p.num_symbols):
        m = data_maps[sym]
        for cpv in cp_pos:
            m[cpv] = CP_INV if (tx2 and (cpv // dx) % 2
                                and cpv % dx == 0) else CP
        rel = (np.arange(C_PS) - K_EXT) % (dx * dy)
        sp_pos = np.nonzero(rel == dx * (sym % dy))[0]
        for i in sp_pos:
            m[i] = SP_INV if (tx2 and (i // dx) % 2) else SP
        m[0] = m[C_PS - 1] = SP_INV if (tx2 and sym % 2) else SP
        if p.paprmode in ("tr", "both"):
            m[_tr_positions(p, sym)] = TRPAPR
    return p2, fc, data_maps


def _tr_shift(p: T2Params, sym: int) -> int:
    if p.carriermode == "extended":
        return p.dx * ((sym + p.K_EXT // p.dx) % p.dy)
    return p.dx * (sym % p.dy)


def _tr_positions(p: T2Params, sym: int) -> np.ndarray:
    return np.array(TR_PAPR[p.fftsize], np.int64) + _tr_shift(p, sym)


@lru_cache(maxsize=16)
def _pilot_plan(p: T2Params):
    """(pilot_flat [S*fft] complex64 with pilots+zeros,
    data_idx [active_items] int32 flat scatter positions,
    eq [fft] float32 or None)."""
    p2m, fcm, dmaps = _carrier_maps(p)
    prbs = _pilot_prbs()
    pn = _pn_sequence()
    S, fft, C_PS = p.num_symbols, p.fft_len, p.C_PS
    left = (fft - C_PS) // 2 + 1
    amp_p2 = (np.sqrt(37.0) / 5.0 if (p.fftsize == "32K" and not p.miso)
              else np.sqrt(31.0) / 5.0)
    amp_sp = SP_AMP[p.pp]
    amp_cp = CP_AMP[p.fftsize]
    pilot = np.zeros((S, fft), np.complex64)
    data_idx = []
    for j in range(S):
        if j < p.N_P2:
            m = p2m
        elif j == S - p.L_FC and p.L_FC:
            m = fcm
        else:
            m = dmaps[j]
        ref = 1.0 - 2.0 * (prbs[np.arange(C_PS) + p.K_OFFSET] ^ pn[j])
        vals = np.zeros(C_PS, np.float64)
        vals[m == P2P] = amp_p2 * ref[m == P2P]
        vals[m == P2P_INV] = -amp_p2 * ref[m == P2P_INV]
        vals[m == SP] = amp_sp * ref[m == SP]
        vals[m == SP_INV] = -amp_sp * ref[m == SP_INV]
        vals[m == CP] = amp_cp * ref[m == CP]
        vals[m == CP_INV] = -amp_cp * ref[m == CP_INV]
        pilot[j, left:left + C_PS] = vals
        dpos = np.nonzero(m == DATA)[0]
        expected = (p.C_P2 if j < p.N_P2
                    else (p.N_FC if (p.L_FC and j == S - 1) else p.C_DATA))
        assert dpos.size == expected, (j, dpos.size, expected)
        data_idx.append(j * fft + left + dpos)
    data_idx = np.concatenate(data_idx).astype(np.int32)
    assert data_idx.size == p.active_items
    eq = _inverse_sinc(p) if p.equalization else None
    return pilot.reshape(-1), data_idx, eq


def _inverse_sinc(p: T2Params) -> np.ndarray:
    fs = BW_FS[p.bandwidth]
    N = p.fft_len
    inv = np.zeros(N, np.float64)
    f = 0.0
    fstep = fs / N
    s2 = 0.0
    for i in range(N // 2):
        x = np.pi * f / fs
        sinc = 1.0 if i == 0 else np.sin(x) / x
        s2 += sinc * sinc
        inv[i + N // 2] = 1.0 / sinc
        inv[N // 2 - i - 1] = 1.0 / sinc
        f += fstep
    return (inv * np.sqrt(s2 / (N // 2))).astype(np.float32)


def pilots_and_ifft(interleaved, p: T2Params):
    """[nf, active_items] cells -> [nf, num_symbols, fft_len] time-domain
    OFDM symbols (pilot scatter + batched centered IFFT)."""
    pilot_flat, data_idx, eq = _pilot_plan(p)
    nf = interleaved.shape[0]
    base = jnp.tile(jnp.asarray(pilot_flat)[None], (nf, 1))
    freq = base.at[:, jnp.asarray(data_idx)].set(
        interleaved.astype(jnp.complex64))
    freq = freq.reshape(nf, p.num_symbols, p.fft_len)
    if eq is not None:
        freq = freq * jnp.asarray(eq)[None, None, :]
    norm = np.float32(5.0 / np.sqrt(27.0 * p.C_PS))
    shifted = jnp.fft.ifftshift(freq, axes=-1)
    time = jnp.fft.ifft(shifted, axis=-1) * (p.fft_len * norm)
    return time.astype(jnp.complex64)


def frame_freq_symbols(interleaved, p: T2Params):
    """Frequency-domain symbols before IFFT (for QA / RX loopback)."""
    pilot_flat, data_idx, _ = _pilot_plan(p)
    nf = interleaved.shape[0]
    base = jnp.tile(jnp.asarray(pilot_flat)[None], (nf, 1))
    freq = base.at[:, jnp.asarray(data_idx)].set(
        interleaved.astype(jnp.complex64))
    return freq.reshape(nf, p.num_symbols, p.fft_len)


def extract_data_cells(freq_syms, p: T2Params):
    """Inverse of the pilot scatter: [nf, S, fft] -> [nf, active_items]."""
    _, data_idx, _ = _pilot_plan(p)
    flat = freq_syms.reshape(freq_syms.shape[0], -1)
    return flat[:, jnp.asarray(data_idx)]


def cyclic_prefix(time_syms, p: T2Params):
    """[nf, S, fft] -> [nf, S*(fft+gi)] guard-interval insertion."""
    gi = time_syms[..., p.fft_len - p.gi_len:]
    return jnp.concatenate([gi, time_syms], axis=-1).reshape(
        time_syms.shape[0], -1)


def p1_insert(frames, p: T2Params):
    """[nf, frame_items] -> [nf, frame_items + 2048] with the C-A-B P1
    preamble (reuses ops.dvbt2.p1_symbol)."""
    from .dvbt2 import p1_symbol
    p1 = jnp.asarray(p1_symbol(p.s1, p.s2_fft))
    nf = frames.shape[0]
    return jnp.concatenate([jnp.tile(p1[None], (nf, 1)), frames], axis=1)


def miso_split(cells):
    """Framemapper-output cells -> (tx1, tx2) per dvbt2_miso_cc: tx1 is a
    passthrough; tx2 pairs (c1,c2) -> (-conj(c2), conj(c1))."""
    c = cells.reshape(cells.shape[:-1] + (-1, 2))
    tx2 = jnp.stack([-jnp.conj(c[..., 1]), jnp.conj(c[..., 0])],
                    axis=-1).reshape(cells.shape)
    return cells, tx2


# ---------------------------------------------------------------------------
# PAPR tone reservation
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _papr_plan(p: T2Params):
    """Per-symbol (ones_time [S, fft] complex64, pos [S, N_TR] int32
    carrier offsets for the phase ramp, active [S] bool)."""
    p2m, fcm, dmaps = _carrier_maps(p)
    S, fft, C_PS = p.num_symbols, p.fft_len, p.C_PS
    left = (fft - C_PS) // 2 + 1
    center = (C_PS - 1) // 2
    n_tr = len(TR_PAPR[p.fftsize])
    ones_time = np.zeros((S, fft), np.complex64)
    pos = np.zeros((S, n_tr), np.int64)
    active = np.zeros(S, bool)
    p2_map = np.array(P2_PAPR[p.fftsize], np.int64)
    tr_map = np.array(TR_PAPR[p.fftsize], np.int64)
    for j in range(S):
        shift = _tr_shift(p, j)
        if j < p.N_P2:
            sel = np.nonzero(p2m == P2PAPR)[0]
            papr_map = p2_map
        elif p.L_FC and j == S - 1:
            if p.paprmode not in ("tr", "both"):
                continue
            sel = np.nonzero(fcm == TRPAPR)[0]
            papr_map = p2_map       # reference uses p2_papr_map here
        else:
            if p.paprmode not in ("tr", "both"):
                continue
            sel = np.nonzero(dmaps[j] == TRPAPR)[0]
            papr_map = tr_map
        ones = np.zeros(fft, np.complex64)
        ones[left + sel] = 1.0
        ot = np.fft.ifft(np.fft.ifftshift(ones)) * fft / n_tr
        ones_time[j] = ot
        pos[j] = papr_map + shift - center
        active[j] = True
    return ones_time, pos.astype(np.int32), active


def papr_tr(time_syms, p: T2Params):
    """Iterative tone-reservation peak cancellation
    (dvbt2_paprtr_cc_impl.cc :755-830), vmapped over all symbols."""
    if p.paprmode not in ("tr", "both") and not (
            p.version == "1.3.1" and p.paprmode == "off"):
        return time_syms
    ones_time, pos, active = _papr_plan(p)
    S, fft = p.num_symbols, p.fft_len
    n_tr = pos.shape[1]
    a_max = np.float32(5.0 * n_tr * np.sqrt(10.0 / (27.0 * p.C_PS)))
    if p.version == "1.3.1" and p.paprmode == "off":
        # reference constructor override (dvbt2_paprtr_cc_impl.cc :522-525)
        vclip, iters = np.float32(3.0), 1
    else:
        vclip, iters = np.float32(p.vclip), p.papr_iterations

    def one_symbol(x, ot, pp):
        def body(carry):
            c, r, k, done = carry
            mag = jnp.abs(x + c)
            m = jnp.argmax(mag)
            y = mag[m]
            stop = y < vclip
            u = (x[m] + c[m]) / y
            alpha0 = y - vclip
            phase = (-2.0 * np.pi) * m.astype(jnp.float32) \
                * pp.astype(jnp.float32) / fft
            v = jnp.exp(1j * phase) * u
            r_new = r - alpha0 * v
            ct = r * jnp.conj(v)
            lim = jnp.sqrt(jnp.maximum(a_max * a_max
                                       - jnp.imag(ct) ** 2, 0.0)) \
                + jnp.real(ct)
            over = jnp.abs(r_new) > a_max
            any_over = jnp.any(over)
            a_min = jnp.min(jnp.where(over, lim, jnp.inf))
            alpha = jnp.where(any_over, a_min, alpha0)
            r_new = jnp.where(any_over, r - alpha * v, r_new)
            kernel = jnp.roll(ot, m)
            c_new = c - u * alpha * kernel
            upd = jnp.logical_and(~done, ~stop)
            c = jnp.where(upd, c_new, c)
            r = jnp.where(upd, r_new, r)
            return (c, r, k + 1, jnp.logical_or(done, stop))

        def cond(carry):
            _, _, k, done = carry
            return jnp.logical_and(k < iters, ~done)

        c0 = jnp.zeros(fft, jnp.complex64)
        r0 = jnp.zeros(n_tr, jnp.complex64)
        c, _, _, _ = jax.lax.while_loop(
            cond, body, (c0, r0, jnp.int32(0), jnp.bool_(False)))
        return x + c

    nf = time_syms.shape[0]
    flat = time_syms.reshape(nf * S, fft)
    ot = jnp.tile(jnp.asarray(ones_time)[None], (nf, 1, 1)).reshape(
        nf * S, fft)
    pp = jnp.tile(jnp.asarray(pos)[None], (nf, 1, 1)).reshape(nf * S, -1)
    out = jax.vmap(one_symbol)(flat, ot, pp)
    act = jnp.tile(jnp.asarray(active)[None], (nf, 1)).reshape(-1)
    out = jnp.where(act[:, None], out, flat)
    return out.reshape(nf, S, fft)


# ---------------------------------------------------------------------------
# cell + time interleaver as one permutation
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def cell_time_perm(framesize: str, constellation: str, fecblocks: int,
                   tiblocks: int) -> np.ndarray:
    """src[fecblocks*cell_size]: out[k] = in[src[k]] for the combined
    pseudo-random cell interleave (per-FEC-block bit-reversed shift,
    counter resetting per TI block) + column/row time interleave
    (dvbt2_cellinterleaver_cc_impl.cc work() :194-260)."""
    from .dvbt2 import _cell_perm, _CI_PARAMS
    cs = CELL_SIZE[(framesize, constellation)]
    deg = _CI_PARAMS[(framesize, constellation)][1]
    perm = _cell_perm(framesize, constellation)
    if tiblocks == 0:
        blocks = [1] * fecblocks
    else:
        nbig = fecblocks % tiblocks
        small = tiblocks - nbig
        fs = fecblocks // tiblocks
        fb = -(-fecblocks // tiblocks)
        blocks = [fs] * small + [fb] * nbig
    dest = np.zeros(fecblocks * cs, np.int64)
    inpos = idx = 0
    for fpt in blocks:
        n = 0
        for r in range(fpt):
            shift = cs
            while shift >= cs:
                t, shift = n, 0
                for _ in range(deg):
                    shift |= t & 1
                    shift <<= 1
                    t >>= 1
                n += 1
            dest[inpos + np.arange(cs)] = ((perm + shift) % cs) + idx
            inpos += cs
            idx += cs
    inv_dest = np.argsort(dest)
    if tiblocks == 0:
        return inv_dest.astype(np.int32)
    src2 = np.zeros(fecblocks * cs, np.int64)
    out = ti_index = 0
    rows = cs // 5
    for fpt in blocks:
        ncols = 5 * fpt
        k, w = np.meshgrid(np.arange(rows), np.arange(ncols), indexing="ij")
        src2[out + (k * ncols + w).ravel()] = \
            ti_index + rows * w.ravel() + k.ravel()
        out += rows * ncols
        ti_index += rows * ncols
    return inv_dest[src2].astype(np.int32)


# ---------------------------------------------------------------------------
# end-to-end modulation
# ---------------------------------------------------------------------------

def dvbt2_modulate(cells, p: T2Params, frame_idx0: int = 0):
    """Cell-interleaver output [nf, stream_items] -> antenna samples
    [nf, frame_items + 2048] (frame map -> freq interleave -> pilots +
    IFFT -> PAPR -> guard interval -> P1)."""
    mapped = frame_map(cells, p, frame_idx0)
    inter = freq_interleave_frame(mapped, p)
    time = pilots_and_ifft(inter, p)
    time = papr_tr(time, p)
    stream = cyclic_prefix(time, p)
    return p1_insert(stream, p)
