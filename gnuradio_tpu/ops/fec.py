"""gr-fec: FECAPI analog — convolutional codes, Reed-Solomon, puncturing.

Reference behavior (reimplemented, not copied):
  gr-fec/lib/cc_encoder_impl.cc   — shift-register conv encoder; state is the
      last k bits (newest at LSB), out bit j = parity(state & polys[j]),
      negative poly inverts; modes CC_STREAMING/TERMINATED/TAILBITING/TRUNCATED
  gr-fec/lib/cc_decoder_impl.cc   — Viterbi decode of the same trellis
  gr-fec/lib/puncture_bb_impl.cc  — keep bits where the puncture pattern
      (puncsize-bit word, MSB-first) has a 1; depuncture reinserts `sym`
  gr-fec/lib/ber_bf_impl.cc       — bit-error counting over packed bytes
  gr-fec generic_encoder/decoder  — (include/gnuradio/fec/generic_decoder.h:48)
      kernel objects wrapped by deployment blocks
  Reed-Solomon: the reference wraps Phil Karn's librs (gr-fec/lib/reed-solomon);
      here RS is built from scratch over GF(2^8): parity = GF matrix product
      (matmul-shaped gathers), decode = syndromes -> Berlekamp-Massey (unrolled
      2t steps) -> Chien search (parallel matvec) -> Forney, batched over
      codewords.

Design: the conv encoder is a windowed parity — bit windows [N, k] times
the poly bit matrix [k, n] mod 2, one int matmul instead of a scalar loop.
The decoder reuses the vectorized Viterbi from ops.trellis. RS works on
uint8-valued int32 arrays with log/antilog gather tables; everything is
batched over codewords (the natural data-parallel axis).
"""
from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block
from ..core.stream import PortSpec, B, F
from .trellis import FSM, TRELLIS_EUCLIDEAN, viterbi_combined

# frame modes (gr-fec/include/gnuradio/fec/cc_common.h)
CC_STREAMING = 0
CC_TERMINATED = 1
CC_TAILBITING = 2
CC_TRUNCATED = 3


# ---------------------------------------------------------------------------
# convolutional code
# ---------------------------------------------------------------------------

def _poly_bits(poly: int, k: int) -> np.ndarray:
    """bits of |poly|: index d = tap on the input d samples ago (LSB=newest,
    matching `state & poly` with state's LSB the newest bit)."""
    p = abs(int(poly))
    return np.array([(p >> d) & 1 for d in range(k)], np.int8)


def cc_fsm(k: int, rate: int, polys) -> FSM:
    """Build the conv-code trellis FSM matching cc_encoder conventions.
    S = 2^(k-1) states holding the previous k-1 bits (newest at LSB);
    output symbol packs the rate bits first-poly-at-MSB."""
    S = 1 << (k - 1)
    NS = np.zeros((S, 2), np.int32)
    OS = np.zeros((S, 2), np.int32)
    for s in range(S):
        for i in (0, 1):
            full = ((s << 1) | i) & ((1 << k) - 1)
            NS[s, i] = full & (S - 1)
            o = 0
            for j, p in enumerate(polys):
                bit = bin(full & abs(int(p))).count("1") & 1
                if int(p) < 0:
                    bit ^= 1
                o = (o << 1) | bit
            OS[s, i] = o
    return FSM(2, S, 1 << rate, NS, OS)


def cc_encode(bits, k: int, rate: int, polys, start_state: int = 0,
              mode: int = CC_STREAMING, _return_state: bool = False):
    """Encode a frame of bits [N] -> [rate*N (+ rate*(k-1) if terminated)].

    Parallel formulation: window the bit stream (delay taps 0..k-1) and
    matmul with the poly bit matrix mod 2 — no sequential shift register.
    """
    bits = bits.astype(jnp.int32) & 1
    N = bits.shape[0]
    polymat = np.stack([_poly_bits(p, k) for p in polys], 1).astype(np.int32)
    inv = np.array([1 if int(p) < 0 else 0 for p in polys], np.int32)

    if mode == CC_TAILBITING:
        head = bits[N - (k - 1):] if k > 1 else bits[:0]
    else:
        ss = int(start_state)
        head = jnp.array([(ss >> (k - 2 - i)) & 1 for i in range(k - 1)],
                         jnp.int32)
    ext = jnp.concatenate([head, bits])
    if mode == CC_TERMINATED:
        ss = int(start_state)
        tail = jnp.array([(ss >> (k - 2 - i)) & 1 for i in range(k - 1)],
                         jnp.int32)
        ext = jnp.concatenate([ext, tail])
    # Per-poly XOR of shifted slices: out[t, r] = XOR over set tap bits of
    # ext[t + k - 1 - c]. Elementwise int8 passes — the earlier (T, k)
    # int32 window stack + matmul materialized ~1 GB at 37M bits; this
    # form is ~6 shifted reads.
    T = ext.shape[0] - (k - 1)
    ext8 = ext.astype(jnp.int8)
    streams = []
    for r in range(polymat.shape[1]):
        acc = None
        for c in range(k):
            if polymat[c, r]:
                sl = jax.lax.slice(ext8, (k - 1 - c,), (k - 1 - c + T,))
                acc = sl if acc is None else acc ^ sl
        if acc is None:
            acc = jnp.zeros(T, jnp.int8)
        if inv[r]:
            acc = acc ^ np.int8(1)
        streams.append(acc)
    out = jnp.stack(streams, axis=1)                       # [T, rate]
    return out.reshape(-1).astype(jnp.int8)


def cc_encode_streaming_state(bits, k):
    """Final start_state after a streaming frame (cc_encoder_impl state
    carry): the last k-1 bits, newest at LSB."""
    n = bits.shape[0]
    tail = bits[n - (k - 1):].astype(jnp.int32) & 1
    w = jnp.asarray(2 ** np.arange(k - 2, -1, -1), jnp.int32)
    return jnp.sum(tail * w)


def cc_decode(soft, frame_size: int, k: int, rate: int, polys,
              mode: int = CC_TERMINATED, start_state: int = 0):
    """Viterbi-decode one frame. soft: [rate*(frame_size (+k-1 if
    terminated))] float soft bits in bipolar form (+1 -> bit 0, -1 -> bit 1,
    i.e. 1-2b). Returns [frame_size] hard bits int8."""
    fsm = cc_fsm(k, rate, polys)
    # table[o] = bipolar pattern of the rate output bits (first poly at MSB)
    table = np.array([[1.0 - 2.0 * ((o >> (rate - 1 - j)) & 1)
                       for j in range(rate)] for o in range(fsm.O)],
                     np.float32)
    if mode == CC_TERMINATED:
        S0 = SK = int(start_state)
        dec = viterbi_combined(fsm, table, rate, TRELLIS_EUCLIDEAN, soft,
                               S0=S0, SK=SK)
        return dec[:frame_size].astype(jnp.int8)
    if mode == CC_TAILBITING:
        dec = viterbi_combined(fsm, table, rate, TRELLIS_EUCLIDEAN, soft,
                               S0=-1, SK=-1)
        return dec[:frame_size].astype(jnp.int8)
    # streaming/truncated: free end state
    dec = viterbi_combined(fsm, table, rate, TRELLIS_EUCLIDEAN, soft,
                           S0=int(start_state), SK=-1)
    return dec[:frame_size].astype(jnp.int8)


def cc_decode_blockparallel(soft, frame_size: int, k: int, rate: int,
                            polys, block: int = 1024, overlap: int = 128,
                            start_state: int = 0):
    """Streaming Viterbi decoded as OVERLAPPED BLOCKS in parallel.

    The reference's viterbi decoder is a strictly sequential per-bit ACS
    loop (core_algorithms.cc:29-140); a multi-million-step lax.scan of
    tiny vector work is the worst possible shape for a parallel device.
    Standard
    overlapped block decoding fixes it: lane l decodes bits
    [l*block - overlap, (l+1)*block + overlap) with free start/end states
    and keeps only its middle `block` bits. With overlap >= ~25
    constraint lengths the kept decisions coincide with the global MAP
    path at any workable SNR (residuals land inside RS's correction
    budget, the same contract DvbtViterbiDecoder already documents for
    chunk-local traceback). All lanes run in ONE vmapped scan of length
    block + 2*overlap — a ~n/block-fold cut in sequential depth.

    soft: [rate*frame_size] bipolar soft bits. Returns [frame_size] int8.
    """
    fsm = cc_fsm(k, rate, polys)
    table = np.array([[1.0 - 2.0 * ((o >> (rate - 1 - j)) & 1)
                       for j in range(rate)] for o in range(fsm.O)],
                     np.float32)
    n = int(frame_size)
    m = soft.shape[0] // rate          # observed trellis steps (may exceed
                                       # frame_size; cc_decode ignores the
                                       # tail the same way)
    if n <= block + 2 * overlap:
        return cc_decode(soft, n, k, rate, polys, mode=CC_STREAMING,
                         start_state=start_state)
    nb = -(-m // block)
    pad_n = nb * block
    s = jnp.pad(soft.astype(jnp.float32)[: m * rate],
                (0, (pad_n - m) * rate))
    sym = s.reshape(pad_n, rate)
    L = block + 2 * overlap
    idx = (jnp.arange(nb)[:, None] * block - overlap
           + jnp.arange(L)[None, :])
    idx = jnp.clip(idx, 0, pad_n - 1)
    obs = sym[idx].reshape(nb, L * rate)

    def lane(o):
        return viterbi_combined(fsm, table, rate, TRELLIS_EUCLIDEAN, o,
                                S0=-1, SK=-1, radix=4)

    dec = jax.vmap(lane)(obs)
    out = dec[:, overlap:overlap + block].reshape(-1)[:n]
    return out.astype(jnp.int8)


class CCEncoder(Block):
    """fec.cc_encoder deployment block: frame_size bits in -> coded bits out."""

    def __init__(self, frame_size: int, k: int, rate: int, polys,
                 start_state: int = 0, mode: int = CC_STREAMING, name=None):
        super().__init__(name)
        self.frame_size, self.k, self.rate = int(frame_size), int(k), int(rate)
        self.polys, self.start_state, self.mode = list(polys), start_state, mode
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)
        self.nout_frame = self.rate * (self.frame_size +
                                       (self.k - 1 if mode == CC_TERMINATED else 0))
        self.output_multiple = self.nout_frame

    @property
    def in_rates(self):
        return (Fraction(self.frame_size),)

    @property
    def out_rates(self):
        return (Fraction(self.nout_frame),)

    def init_state(self):
        if self.mode == CC_STREAMING:
            return {"ss": jnp.int32(self.start_state)}
        return None

    def apply(self, state, inputs, n_in):
        frames = inputs[0].reshape(-1, self.frame_size)
        if self.mode == CC_STREAMING:
            # sequential dependence across frames via carried state
            def step(ss, fr):
                out = _cc_encode_dyn(fr, self.k, self.rate, self.polys, ss)
                ns = cc_encode_streaming_state(fr, self.k)
                return ns, out
            ss, outs = jax.lax.scan(step, state["ss"], frames)
            return {"ss": ss}, (outs.reshape(-1),)
        enc = jax.vmap(lambda fr: cc_encode(
            fr, self.k, self.rate, self.polys, self.start_state, self.mode))(frames)
        return state, (enc.reshape(-1),)


def _cc_encode_dyn(bits, k, rate, polys, start_state):
    """cc_encode with a *traced* start_state (streaming mode)."""
    bits = bits.astype(jnp.int32) & 1
    head = jnp.stack([(start_state >> (k - 2 - i)) & 1 for i in range(k - 1)])
    ext = jnp.concatenate([head.astype(jnp.int32), bits])
    T = ext.shape[0] - (k - 1)
    wins = jnp.stack([ext[d: d + T] for d in range(k - 1, -1, -1)], axis=1)
    polymat = np.stack([_poly_bits(p, k) for p in polys], 1).astype(np.int32)
    inv = np.array([1 if int(p) < 0 else 0 for p in polys], np.int32)
    out = (wins @ jnp.asarray(polymat)) % 2 ^ jnp.asarray(inv)[None, :]
    return out.reshape(-1).astype(jnp.int8)


class CCDecoder(Block):
    """fec.cc_decoder deployment block: float soft bits in -> hard bits out."""

    def __init__(self, frame_size: int, k: int, rate: int, polys,
                 start_state: int = 0, mode: int = CC_TERMINATED, name=None):
        super().__init__(name)
        self.frame_size, self.k, self.rate = int(frame_size), int(k), int(rate)
        self.polys, self.start_state, self.mode = list(polys), start_state, mode
        self.in_ports = (PortSpec(F),)
        self.out_ports = (PortSpec(B),)
        self.nin_frame = self.rate * (self.frame_size +
                                      (self.k - 1 if mode == CC_TERMINATED else 0))
        self.output_multiple = self.frame_size

    @property
    def in_rates(self):
        return (Fraction(self.nin_frame),)

    @property
    def out_rates(self):
        return (Fraction(self.frame_size),)

    def apply(self, state, inputs, n_in):
        frames = inputs[0].reshape(-1, self.nin_frame)
        dec = jax.vmap(lambda fr: cc_decode(
            fr, self.frame_size, self.k, self.rate, self.polys, self.mode,
            self.start_state))(frames)
        return state, (dec.reshape(-1),)


# ---------------------------------------------------------------------------
# puncturing (gr-fec/lib/puncture_bb_impl.cc, depuncture_bb_impl.cc)
# ---------------------------------------------------------------------------

def _punc_keep(puncsize: int, puncpat: int, delay: int = 0) -> np.ndarray:
    """Indices (within one puncsize period) kept by the pattern; pattern is
    MSB-first over the period, rotated by delay."""
    keep = []
    for i in range(puncsize):
        if (puncpat >> (puncsize - 1 - ((i + delay) % puncsize))) & 1:
            keep.append(i)
    return np.array(keep, np.int64)


class PunctureBB(Block):
    def __init__(self, puncsize: int, puncpat: int, delay: int = 0,
                 dtype=B, name=None):
        super().__init__(name)
        self.puncsize = int(puncsize)
        self.keep = _punc_keep(puncsize, puncpat, delay)
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)

    @property
    def in_rates(self):
        return (Fraction(self.puncsize),)

    @property
    def out_rates(self):
        return (Fraction(len(self.keep)),)

    def apply(self, state, inputs, n_in):
        x = inputs[0].reshape(-1, self.puncsize)
        return state, (x[:, jnp.asarray(self.keep)].reshape(-1),)


class DepunctureBB(Block):
    def __init__(self, puncsize: int, puncpat: int, delay: int = 0,
                 sym=0.0, dtype=F, name=None):
        super().__init__(name)
        self.puncsize = int(puncsize)
        self.keep = _punc_keep(puncsize, puncpat, delay)
        self.sym = sym
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)

    @property
    def in_rates(self):
        return (Fraction(len(self.keep)),)

    @property
    def out_rates(self):
        return (Fraction(self.puncsize),)

    def apply(self, state, inputs, n_in):
        x = inputs[0].reshape(-1, len(self.keep))
        out = jnp.full((x.shape[0], self.puncsize), self.sym,
                       dtype=x.dtype)
        out = out.at[:, jnp.asarray(self.keep)].set(x)
        return state, (out.reshape(-1),)


def puncture(x, puncsize, puncpat, delay=0):
    keep = _punc_keep(puncsize, puncpat, delay)
    return x.reshape(-1, puncsize)[:, jnp.asarray(keep)].reshape(-1)


def depuncture(x, puncsize, puncpat, delay=0, sym=0.0):
    keep = _punc_keep(puncsize, puncpat, delay)
    xr = x.reshape(-1, len(keep))
    out = jnp.full((xr.shape[0], puncsize), sym, dtype=x.dtype)
    return out.at[:, jnp.asarray(keep)].set(xr).reshape(-1)


# ---------------------------------------------------------------------------
# GF(2^8) and Reed-Solomon
# ---------------------------------------------------------------------------

class GF256:
    """GF(2^8) arithmetic tables for a given primitive polynomial.
    DVB/MPEG uses p(x)=x^8+x^4+x^3+x^2+1 (0x11d); CCSDS uses 0x187."""

    def __init__(self, prim_poly: int = 0x11D, alpha: int = 2):
        exp = np.zeros(510, np.int32)
        log = np.zeros(256, np.int32)
        x = 1
        for i in range(255):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= prim_poly
        exp[255:510] = exp[0:255]
        self.prim_poly = prim_poly
        self.exp_np, self.log_np = exp, log
        # stored as NUMPY: jnp constants created inside one jit trace leak
        # as tracers when the (cached) instance is reused in another trace;
        # numpy operands lift to device constants per-trace safely
        self.exp = np.asarray(exp)
        self.log = np.asarray(log)

    # host-side scalar helpers (table construction)
    def mul_np(self, a, b):
        a, b = np.asarray(a), np.asarray(b)
        out = self.exp_np[(self.log_np[a] + self.log_np[b]) % 255]
        return np.where((a == 0) | (b == 0), 0, out)

    def poly_mul_np(self, p, q):
        out = np.zeros(len(p) + len(q) - 1, np.int32)
        for i, pi in enumerate(p):
            out[i: i + len(q)] ^= self.mul_np(pi, np.asarray(q, np.int32))
        return out

    # device-side vector ops (tables lifted per-trace: numpy arrays can't
    # be INDEXED by tracers, and jnp attrs stored at __init__ leak tracers
    # across traces — so convert at use)
    def mul(self, a, b):
        exp, log = jnp.asarray(self.exp), jnp.asarray(self.log)
        out = exp[log[a] + log[b]]
        return jnp.where((a == 0) | (b == 0), 0, out)

    def inv(self, a):
        exp, log = jnp.asarray(self.exp), jnp.asarray(self.log)
        return exp[255 - log[a]]  # undefined at 0 (callers mask)

    def mul_clmul(self, a, b):
        """GF(2^8) multiply as a carry-less shift-XOR product + modular
        reduction — pure elementwise int ops, NO table gathers. The
        log/exp-gather form costs 3 gathers per multiply, times the ~400
        multiplies in the unrolled Berlekamp-Massey/Forney decode path."""
        a = a.astype(jnp.int32)
        b = b.astype(jnp.int32)
        p = jnp.zeros(jnp.broadcast_shapes(a.shape, b.shape), jnp.int32)
        for i in range(8):
            p = p ^ (jnp.where(((a >> i) & 1) == 1, b, 0) << i)
        for bit in range(14, 7, -1):
            p = p ^ jnp.where(((p >> bit) & 1) == 1,
                              self.prim_poly << (bit - 8), 0)
        return p

    def inv_clmul(self, a):
        """a^254 by square-and-multiply (13 mul_clmul) — gather-free
        Fermat inverse; returns garbage at 0 like inv (callers mask)."""
        sq = a
        out = None
        for bit in range(1, 8):        # 254 = bits 1..7
            sq = self.mul_clmul(sq, sq)
            out = sq if out is None else self.mul_clmul(out, sq)
        return out

    def matvec(self, M_log, M_nz, v):
        """XOR-reduce_k M[., k] * v[k] with M given as log table + nonzero
        mask (precomputed host-side). v: [..., K] -> [..., J]."""
        exp, log = jnp.asarray(self.exp), jnp.asarray(self.log)
        prod = exp[jnp.asarray(M_log) + log[v][..., None, :]]
        prod = jnp.where(jnp.asarray(M_nz) & (v[..., None, :] != 0), prod, 0)
        # XOR-reduce along K
        return _xor_reduce(prod, axis=-1)


def _xor_reduce(x, axis=-1):
    n = x.shape[axis]
    # log2 tree of bitwise XORs (elementwise int ops)
    while n > 1:
        half = n // 2
        a = jax.lax.slice_in_dim(x, 0, half, axis=axis)
        b = jax.lax.slice_in_dim(x, half, 2 * half, axis=axis)
        rest = jax.lax.slice_in_dim(x, 2 * half, n, axis=axis)
        x = jnp.concatenate([a ^ b, rest], axis=axis)
        n = half + (n - 2 * half)
    return jnp.squeeze(x, axis=axis)


class ReedSolomon:
    """RS(n=255, k=255-2t) over GF(2^8), with shortening support.

    encode: parity = data x P where P[i,j] is the precomputed remainder
    matrix (host NumPy, once). decode: syndromes (GF matvec) ->
    Berlekamp-Massey (2t unrolled steps, fully batched) -> Chien search
    (matvec over all 255 positions) -> Forney. Everything vmaps over the
    codeword batch axis.

    DVB-T RS(204,188): ReedSolomon(t=8, prim=0x11d, fcr=0, shorten=51)
    (gr-dtv/lib/dvbt/dvbt_reed_solomon_enc_impl.cc params p=2,m=8,gfpoly=0x11d,
    n=204,k=188,t=8,s=51).
    """

    def __init__(self, t: int = 8, prim_poly: int = 0x11D, fcr: int = 0,
                 shorten: int = 0):
        self.gf = GF256(prim_poly)
        self.t, self.fcr, self.shorten = int(t), int(fcr), int(shorten)
        self.n = 255 - self.shorten
        self.k = self.n - 2 * t
        gf = self.gf
        # generator g(x) = prod_{i=0}^{2t-1} (x - alpha^(fcr+i))
        g = np.array([1], np.int32)
        for i in range(2 * t):
            g = gf.poly_mul_np(g, [1, gf.exp_np[(fcr + i) % 255]])
        self.gen = g  # degree 2t, g[0]=1 (monic, highest power first)
        # parity matrix: P[i] = x^(2t) * x^(K-1-i) mod g(x), K=255-2t
        K = 255 - 2 * t
        P = np.zeros((K, 2 * t), np.int32)
        # P[K-1] = x^(2t) mod g, then each previous row is x * (row below):
        # one incremental multiply-by-x per row instead of O(n) per row
        r = np.zeros(2 * t, np.int32)  # coefficients, highest power first
        r[-1] = 1  # x^0
        for _ in range(2 * t):
            carry = r[0]
            r = np.concatenate([r[1:], [0]])
            if carry:
                r ^= gf.mul_np(carry, g[1:])
        P[K - 1] = r
        for i in range(K - 2, -1, -1):
            carry = r[0]
            r = np.concatenate([r[1:], [0]])
            if carry:
                r ^= gf.mul_np(carry, g[1:])
            P[i] = r
        self.P_log = np.asarray(gf.log_np[P.T])        # [2t, K]
        self.P_nz = np.asarray(P.T != 0)
        # syndrome matrix: S_j = sum_p r_p alpha^{(fcr+j)(n-1-p)}, full n=255
        j_idx = np.arange(2 * t)[:, None]
        p_idx = np.arange(255)[None, :]
        Smat = gf.exp_np[((self.fcr + j_idx) * (254 - p_idx)) % 255]
        self.S_log = np.asarray(gf.log_np[Smat])       # [2t, 255]
        self.S_nz = np.asarray(Smat != 0)
        # Chien matrix: eval at X^{-1} = alpha^{-(n-1-p)} for each position p:
        # V[p] = sum_j Lambda[j] * alpha^{-j(254-p)}
        jj = np.arange(t + 1)[None, :]
        pp = np.arange(255)[:, None]
        Cmat = gf.exp_np[(-jj * (254 - pp)) % 255]
        self.C_log = np.asarray(gf.log_np[Cmat])       # [255, t+1]
        self.C_nz = np.asarray(Cmat != 0)
        # same grid for Omega (degree 2t-1) and Lambda' evaluation
        jo = np.arange(2 * t)[None, :]
        Omat = gf.exp_np[(-jo * (254 - pp)) % 255]
        self.O_log = np.asarray(gf.log_np[Omat])
        self.O_nz = np.asarray(Omat != 0)
        # X_p = alpha^{254-p} (error locator value per position)
        self.Xpos = np.asarray(gf.exp_np[(254 - pp.ravel()) % 255])

    # ---- encode ----
    def _bit_gen_matrix(self):
        """RS over GF(2^8) is GF(2)-LINEAR in the input bits, so the whole
        systematic encode is one XOR-matmul: BitGen[(i,b), (j,c)] = bit c of
        parity byte j for the unit input (byte i = 1<<b). Precomputed once
        (host numpy); encode then runs as a matmul mod 2 instead of
        per-byte GF log/exp gathers."""
        if getattr(self, "_BG", None) is None:
            gf = self.gf
            # parity_j(unit i value v) = mul(P[i, j], v); P rows via exp/log
            P = gf.exp_np[self.P_log] * self.P_nz          # [2t, 255-2t]
            K, t2 = self.k, 2 * self.t
            # data occupies the LAST k columns of the length-(255-2t) info
            # block (leading `shorten` columns are zero)
            cols = self.shorten + np.arange(K)
            BG = np.zeros((K * 8, t2 * 8), np.float32)
            for ii, col in enumerate(cols):
                for b in range(8):
                    pbytes = gf.mul_np(P[:, col], 1 << b)  # [2t]
                    bits = ((pbytes[:, None] >> np.arange(8)[None, :]) & 1)
                    BG[ii * 8 + b] = bits.reshape(-1)
            self._BG = BG
        return self._BG

    def encode(self, data):
        """data: [..., k] int (0..255) -> [..., n] systematic codeword."""
        data = data.astype(jnp.int32)
        BG = jnp.asarray(self._bit_gen_matrix())
        bits = ((data[..., None] >> jnp.arange(8)) & 1).reshape(
            data.shape[:-1] + (self.k * 8,)).astype(jnp.float32)
        pb = jnp.dot(bits, BG, precision=jax.lax.Precision.HIGHEST)
        pbits = (pb.astype(jnp.int32) & 1).reshape(
            data.shape[:-1] + (2 * self.t, 8))
        parity = jnp.sum(pbits << jnp.arange(8), axis=-1)
        return jnp.concatenate([data, parity], axis=-1)

    # ---- decode ----
    def _bitlin(self, name, M_log, M_nz):
        """Constant GF matrix out[..., J] = sum_K M[J,K]*v[K] lowered to a
        GF(2) bit-matmul: multiplying by a CONSTANT GF(2^8) element is
        linear over the operand's bits, so the whole polynomial evaluation
        becomes one [K*8, J*8] f32 matmul instead of ~J*K exp/log table
        gathers."""
        key = "_BL_" + name
        B = getattr(self, key, None)
        if B is None:
            A = (self.gf.exp_np[np.asarray(M_log)]
                 * np.asarray(M_nz)).astype(np.int64)     # [J, K]
            J, K = A.shape
            B = np.zeros((K * 8, J * 8), np.float32)
            for k_i in range(K):
                col = A[:, k_i]                           # [J]
                for b in range(8):
                    prod = self.gf.mul_np(col, 1 << b)    # [J]
                    bits = ((prod[:, None] >> np.arange(8)) & 1)
                    B[k_i * 8 + b] = bits.reshape(-1)
            setattr(self, key, B)
        return B

    def _apply_bitlin(self, v, name, M_log, M_nz):
        B = self._bitlin(name, M_log, M_nz)
        K8, J8 = B.shape
        bits = ((v[..., None] >> jnp.arange(8)) & 1).reshape(
            v.shape[:-1] + (K8,)).astype(jnp.float32)
        ob = jnp.dot(bits, jnp.asarray(B),
                     precision=jax.lax.Precision.HIGHEST)
        ob = (ob.astype(jnp.int32) & 1).reshape(v.shape[:-1] + (J8 // 8, 8))
        return jnp.sum(ob << jnp.arange(8), axis=-1)

    def decode(self, rx):
        """rx: [..., n] -> (corrected [..., k], n_errors detected flag).
        Corrects up to t symbol errors per codeword."""
        gf, t = self.gf, self.t
        rx = rx.astype(jnp.int32)
        if self.shorten:
            pad = jnp.zeros(rx.shape[:-1] + (self.shorten,), jnp.int32)
            full = jnp.concatenate([pad, rx], axis=-1)    # [..., 255]
        else:
            full = rx
        S = self._apply_bitlin(full, "S", self.S_log, self.S_nz)
        batch = S.shape[:-1]
        # gather-free GF ops for the unrolled BM/Omega/Forney below: the
        # shift-XOR form replaces ~400 log/exp-gather multiplies with
        # fused elementwise work
        _mul, _inv = gf.mul_clmul, gf.inv_clmul

        # Berlekamp-Massey, unrolled 2t iterations, arrays deg <= t
        Lam = jnp.zeros(batch + (t + 1,), jnp.int32).at[..., 0].set(1)
        Bpoly = jnp.zeros(batch + (t + 1,), jnp.int32).at[..., 0].set(1)
        L = jnp.zeros(batch, jnp.int32)
        b = jnp.ones(batch, jnp.int32)
        for n_it in range(2 * t):
            # discrepancy d = sum_i Lam[i] * S[n_it - i]
            d = jnp.zeros(batch, jnp.int32)
            for i in range(min(t, n_it) + 1):
                d = d ^ _mul(Lam[..., i], S[..., n_it - i])
            coef = _mul(d, _inv(jnp.maximum(b, 1)))
            # shifted B: x * B
            Bshift = jnp.concatenate(
                [jnp.zeros(batch + (1,), jnp.int32), Bpoly[..., :-1]], axis=-1)
            Lam_new = Lam ^ _mul(coef[..., None], Bshift)
            upd = (d != 0)
            grow = upd & (2 * L <= n_it)
            Bpoly = jnp.where(grow[..., None], Lam, Bshift)
            b = jnp.where(grow, d, b)
            L = jnp.where(grow, n_it + 1 - L, L)
            Lam = jnp.where(upd[..., None], Lam_new, Lam)
            # when d==0, B still shifts (m increment folded into shift)
            Bpoly = jnp.where(upd[..., None], Bpoly, Bshift)

        # Omega = S * Lam mod x^{2t}
        Om = jnp.zeros(batch + (2 * t,), jnp.int32)
        for j in range(2 * t):
            acc = jnp.zeros(batch, jnp.int32)
            for i in range(min(j, t) + 1):
                acc = acc ^ _mul(Lam[..., i], S[..., j - i])
            Om = Om.at[..., j].set(acc)

        # Chien: V[p] = Lam(X_p^{-1}) over all 255 positions
        V = self._apply_bitlin(Lam, "C", self.C_log, self.C_nz)
        err_here = (V == 0)
        # Lambda'(x): odd-degree terms only -> Lam'[j] = Lam[j+1] for even j
        Lp = jnp.zeros(batch + (t + 1,), jnp.int32)
        for j in range(1, t + 1, 2):
            Lp = Lp.at[..., j - 1].set(Lam[..., j])
        Lp_val = self._apply_bitlin(Lp, "C", self.C_log, self.C_nz)
        Om_val = self._apply_bitlin(Om, "O", self.O_log, self.O_nz)
        # Forney (fcr-general): e_p = X_p^{1-fcr} * Om(X^{-1}) / Lam'(X^{-1})
        Xp = self.Xpos  # [255]
        x_pow = gf.exp[(self.gf.log[Xp] * ((1 - self.fcr) % 255)) % 255]
        num = _mul(x_pow[None] if batch else x_pow, Om_val)
        mag = _mul(num, _inv(jnp.maximum(Lp_val, 1)))
        mag = jnp.where(err_here & (Lp_val != 0), mag, 0)
        corrected = full ^ mag
        nerr = jnp.sum(err_here, axis=-1)
        data = corrected[..., self.shorten: self.shorten + self.k]
        return data, nerr


class BERSink(Block):
    """fec.ber_bf analog: two packed-byte streams in, running BER out (one
    float per test_bits window — here one value per chunk)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.in_ports = (PortSpec(B), PortSpec(B))
        self.out_ports = (PortSpec(F),)

    def apply(self, state, inputs, n_in):
        a = inputs[0].astype(jnp.int32) & 0xFF
        bvals = inputs[1].astype(jnp.int32) & 0xFF
        x = a ^ bvals
        # popcount via 8 shifts
        cnt = jnp.zeros_like(x)
        for s in range(8):
            cnt = cnt + ((x >> s) & 1)
        total = jnp.sum(cnt).astype(jnp.float32)
        nbits = 8.0 * a.shape[0]
        ber = jnp.full((inputs[0].shape[0],), total / nbits, jnp.float32)
        return state, (ber,)


def bit_errors(a, b):
    """Total differing bits between two packed uint8 streams."""
    x = (a.astype(jnp.int32) & 0xFF) ^ (b.astype(jnp.int32) & 0xFF)
    cnt = jnp.zeros_like(x)
    for s in range(8):
        cnt = cnt + ((x >> s) & 1)
    return jnp.sum(cnt)
