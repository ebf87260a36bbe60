"""FECAPI — the uniform encoder/decoder kernel API + deployments.

Reference parity:
  generic_encoder/generic_decoder   gr-fec/include/gnuradio/fec/
                                    generic_{encoder,decoder}.h (:48) — the
                                    abstract kernel every code implements
  encoder/decoder (streaming)       gr-fec/lib/{encoder,decoder}_impl.cc
  tagged_encoder/tagged_decoder     gr-fec/lib/tagged_{en,de}coder_impl.cc
  async_encoder/async_decoder       gr-fec/lib/async_{en,de}coder_impl.cc —
                                    PDU (message) deployments
  extended_encoder/decoder          gr-fec/python/fec/extended_encoder.py —
                                    puncture + pack wiring around the kernel
  ber_curve harness                 gr-fec/python/fec/bercurve* + fec_test

Design: a *code* is a frame-level pair of pure functions —
encode_frames((F, k) bits) -> (F, n) bits and decode_frames((F, n) soft) ->
(F, k) bits — vmapped over the frame axis so a whole step's frames become
one batched device program (vs the reference's one-frame-at-a-time
generic_work). Soft-bit convention matches the reference's default metric:
bipolar, POSITIVE = bit 0 (1 - 2b).

Deployments wrap any code uniformly:
  fec.encoder(code)                 streaming block, k bits in / n bits out
  fec.decoder(code)                 streaming block, n soft in / k bits out
  fec.tagged_encoder(code, key)     same + packet_len tag rescaling k->n
  fec.async_encoder(code)           PDU in ('in' port) -> PDU out ('out')
"""
from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core import pmt
from ..core.block import Block
from ..core.stream import PortSpec, B, F
from ..core.tags import Tag
from . import fec as _fec
from .fec import (CC_STREAMING, CC_TERMINATED, CC_TAILBITING,
                  CC_TRUNCATED)


# ---------------------------------------------------------------------------
# generic code kernels (generic_encoder/generic_decoder analogs)
# ---------------------------------------------------------------------------

class GenericCode:
    """The FECAPI kernel protocol. Subclasses/adapters define:
       k_bits : info bits per frame (get_input_size analog, encoder side)
       n_bits : coded bits per frame (get_output_size)
       encode_frames(u)    : (F, k_bits) int bits -> (F, n_bits) int8
       decode_frames(soft) : (F, n_bits) float32 bipolar (+1 = bit 0)
                             -> (F, k_bits) int8
    """

    k_bits: int
    n_bits: int

    def rate(self) -> float:
        """generic_encoder::rate analog (output/input)."""
        return self.n_bits / self.k_bits

    def encode_frames(self, u):
        raise NotImplementedError

    def decode_frames(self, soft):
        raise NotImplementedError


class CCCode(GenericCode):
    """Convolutional code kernel (cc_encoder/cc_decoder analog,
    gr-fec/lib/cc_{en,de}coder_impl.cc). Terminated / tailbiting / truncated
    per-frame modes (streaming mode needs cross-frame state — use the
    dedicated CCEncoder block in ops.fec for that)."""

    def __init__(self, frame_size: int, k: int = 7, rate: int = 2,
                 polys=(0o171, 0o133), mode: int = CC_TERMINATED,
                 start_state: int = 0):
        if mode == CC_STREAMING:
            # the reference's streaming mode carries encoder state across
            # frames; the batched per-frame kernel resets it each frame —
            # encode/decode stay mutually consistent (truncated per frame),
            # only the cross-frame state continuity differs. The fully
            # streaming form lives in ops.fec.CCEncoder/CCDecoder.
            mode = CC_TRUNCATED
        self.frame_size, self.k, self.cc_rate = int(frame_size), int(k), int(rate)
        self.polys, self.mode, self.start_state = list(polys), mode, start_state
        self.k_bits = self.frame_size
        self.n_bits = rate * (frame_size + (k - 1 if mode == CC_TERMINATED
                                            else 0))

    def encode_frames(self, u):
        return jax.vmap(lambda fr: _fec.cc_encode(
            fr, self.k, self.cc_rate, self.polys, self.start_state,
            self.mode))(u)

    def decode_frames(self, soft):
        return jax.vmap(lambda s: _fec.cc_decode(
            s, self.frame_size, self.k, self.cc_rate, self.polys,
            self.mode, self.start_state))(soft)


class RSCode(GenericCode):
    """Reed-Solomon bit-level kernel over the byte code in ops.fec
    (gr-fec rs.h / ENCODE_RS usage): k bytes -> n bytes, exposed as bits
    MSB-first so it deploys uniformly."""

    def __init__(self, rs=None, t: int = 8, shorten: int = 0):
        self.rs = rs if rs is not None else _fec.ReedSolomon(t=t,
                                                             shorten=shorten)
        self.k_bits = self.rs.k * 8
        self.n_bits = self.rs.n * 8

    @staticmethod
    def _bits_to_bytes(bits):
        w = jnp.asarray(2 ** np.arange(7, -1, -1), jnp.int32)
        return jnp.sum(bits.reshape(bits.shape[0], -1, 8) * w, axis=-1)

    @staticmethod
    def _bytes_to_bits(by):
        sh = jnp.asarray(np.arange(7, -1, -1), jnp.int32)
        return ((by[..., None] >> sh) & 1).reshape(by.shape[0], -1)

    def encode_frames(self, u):
        data = self._bits_to_bytes(u.astype(jnp.int32))
        cw = jax.vmap(self.rs.encode)(data)
        return self._bytes_to_bits(cw.astype(jnp.int32)).astype(jnp.int8)

    def decode_frames(self, soft):
        hard = (soft < 0).astype(jnp.int32)  # bipolar -> bits
        cw = self._bits_to_bytes(hard)
        dec = jax.vmap(self.rs.decode)(cw)
        if isinstance(dec, tuple):
            dec = dec[0]
        return self._bytes_to_bits(dec.astype(jnp.int32)
                                   [..., : self.rs.k]).astype(jnp.int8)


class LdpcCode(GenericCode):
    """LDPC kernel over ops.fec_ldpc.LdpcCode (alist/H-matrix constructions;
    ldpc_G_matrix encode + BP min-sum decode analogs)."""

    def __init__(self, ldpc, iterations: int = 20):
        self.ldpc = ldpc
        self.iterations = int(iterations)
        self.k_bits, self.n_bits = ldpc.k, ldpc.n

    def encode_frames(self, u):
        return self.ldpc.encode(u).astype(jnp.int8)

    def decode_frames(self, soft):
        cw = self.ldpc.decode(soft, iterations=self.iterations)
        return self.ldpc.extract_info(cw).astype(jnp.int8)


class PolarCode(GenericCode):
    """Polar kernel (SC or SC-list) over ops.fec_polar."""

    def __init__(self, polar, use_list: bool = False):
        self.polar = polar
        self.use_list = use_list
        self.k_bits, self.n_bits = polar.k, polar.n

    def encode_frames(self, u):
        return self.polar.encode(u)

    def decode_frames(self, soft):
        if not self.use_list:
            return jax.vmap(self.polar.decode)(soft)
        # SC-LIST decoding is host NumPy (data-dependent path pruning —
        # ops/fec_polar.PolarCodeList docstring): cross the boundary via
        # pure_callback so the streaming FecDecoder still composes under
        # the jitted graph step.
        import numpy as np

        def host(s):
            return np.stack([self.polar.decode_list(r)
                             for r in np.asarray(s)]).astype(np.int8)

        shape = jax.ShapeDtypeStruct((soft.shape[0], self.k_bits), jnp.int8)
        return jax.pure_callback(host, shape, soft)


class TpcCode(GenericCode):
    """Turbo-product kernel over ops.fec_tpc.TPC."""

    def __init__(self, tpc, iterations: int = 4):
        self.tpc = tpc
        self.iterations = int(iterations)
        self.k_bits, self.n_bits = tpc.k, tpc.n

    def encode_frames(self, u):
        return jax.vmap(self.tpc.encode)(u).astype(jnp.int8)

    def decode_frames(self, soft):
        return jax.vmap(lambda s: self.tpc.decode(
            s, iterations=self.iterations))(soft).astype(jnp.int8)


class RepetitionCode(GenericCode):
    """repetition_encoder/decoder analog (gr-fec repetition): each bit
    repeated `rep` times; decode = soft majority (sum of LLRs)."""

    def __init__(self, frame_size: int, rep: int = 3):
        self.rep = int(rep)
        self.k_bits = int(frame_size)
        self.n_bits = self.k_bits * self.rep

    def encode_frames(self, u):
        return jnp.repeat(u.astype(jnp.int8), self.rep, axis=-1)

    def decode_frames(self, soft):
        s = soft.reshape(soft.shape[0], self.k_bits, self.rep).sum(-1)
        return (s < 0).astype(jnp.int8)


class DummyCode(GenericCode):
    """dummy_encoder/decoder analog: identity (hard-slices on decode)."""

    def __init__(self, frame_size: int):
        self.k_bits = self.n_bits = int(frame_size)

    def encode_frames(self, u):
        return u.astype(jnp.int8)

    def decode_frames(self, soft):
        return (soft < 0).astype(jnp.int8)


# ---------------------------------------------------------------------------
# streaming deployments (fec.encoder / fec.decoder analogs)
# ---------------------------------------------------------------------------

class FecEncoder(Block):
    """Streaming deployment: k_bits in -> n_bits out per frame, whole frames
    per step (the encoder_impl.cc fixed-frame discipline; set_output_multiple
    analog via output_multiple)."""

    def __init__(self, code: GenericCode, name=None):
        super().__init__(name)
        self.code = code
        self.in_ports = (PortSpec(B),)
        self.out_ports = (PortSpec(B),)
        self.output_multiple = code.n_bits

    @property
    def in_rates(self):
        return (Fraction(self.code.k_bits),)

    @property
    def out_rates(self):
        return (Fraction(self.code.n_bits),)

    def apply(self, state, inputs, n_in):
        u = inputs[0].reshape(-1, self.code.k_bits)
        y = self.code.encode_frames(u)
        return state, (y.reshape(-1).astype(jnp.int8),)


class FecDecoder(Block):
    """Streaming deployment: n_bits soft floats in -> k_bits hard bits out."""

    def __init__(self, code: GenericCode, name=None):
        super().__init__(name)
        self.code = code
        self.in_ports = (PortSpec(F),)
        self.out_ports = (PortSpec(B),)
        self.output_multiple = code.k_bits

    @property
    def in_rates(self):
        return (Fraction(self.code.n_bits),)

    @property
    def out_rates(self):
        return (Fraction(self.code.k_bits),)

    def apply(self, state, inputs, n_in):
        s = inputs[0].reshape(-1, self.code.n_bits)
        u = self.code.decode_frames(s)
        return state, (u.reshape(-1).astype(jnp.int8),)


class FecTaggedEncoder(FecEncoder):
    """tagged_encoder analog: packet_len tags rescale k -> n exactly."""

    def __init__(self, code, len_tag_key: str = "packet_len", name=None):
        super().__init__(code, name)
        self.len_tag_key = len_tag_key

    def transform_tags(self, tags_in, in_win, out_win):
        rr = Fraction(self.code.n_bits, self.code.k_bits)
        out = []
        for t in tags_in:
            off = int(t.offset * rr)
            val = (int(t.value * rr) if t.key == self.len_tag_key else t.value)
            out.append(Tag(off, t.key, val, t.srcid))
        return out


class FecTaggedDecoder(FecDecoder):
    """tagged_decoder analog: packet_len tags rescale n -> k exactly."""

    def __init__(self, code, len_tag_key: str = "packet_len", name=None):
        super().__init__(code, name)
        self.len_tag_key = len_tag_key

    def transform_tags(self, tags_in, in_win, out_win):
        rr = Fraction(self.code.k_bits, self.code.n_bits)
        out = []
        for t in tags_in:
            off = int(t.offset * rr)
            val = (int(t.value * rr) if t.key == self.len_tag_key else t.value)
            out.append(Tag(off, t.key, val, t.srcid))
        return out


# ---------------------------------------------------------------------------
# async (PDU) deployments (async_encoder/async_decoder analogs)
# ---------------------------------------------------------------------------

class FecAsyncEncoder(Block):
    """async_encoder analog: PDU of unpacked bits in on 'in', encoded-bit
    PDU out on 'out'. Runs the frame kernel under jit per message (packet
    rate << sample rate, matching the reference's per-PDU work)."""

    def __init__(self, code: GenericCode, name=None):
        super().__init__(name)
        self.code = code
        self.message_port_register_in("in", self._handle)
        self.message_port_register_out("out")
        self._enc = jax.jit(lambda u: code.encode_frames(u))

    def _handle(self, msg):
        meta, data = msg
        bits = np.asarray(data).astype(np.int8) & 1
        if len(bits) % self.code.k_bits:
            pad = self.code.k_bits - len(bits) % self.code.k_bits
            bits = np.concatenate([bits, np.zeros(pad, np.int8)])
        y = np.asarray(self._enc(jnp.asarray(bits.reshape(-1,
                                                          self.code.k_bits))))
        self.post("out", pmt.make_pdu(meta, y.reshape(-1).astype(np.uint8)))


class FecAsyncDecoder(Block):
    """async_decoder analog: PDU of float32 soft bits in, decoded bits out."""

    def __init__(self, code: GenericCode, name=None):
        super().__init__(name)
        self.code = code
        self.message_port_register_in("in", self._handle)
        self.message_port_register_out("out")
        self._dec = jax.jit(lambda s: code.decode_frames(s))

    def _handle(self, msg):
        meta, data = msg
        soft = np.asarray(data, np.float32)
        if len(soft) % self.code.n_bits:
            pad = self.code.n_bits - len(soft) % self.code.n_bits
            soft = np.concatenate([soft, np.zeros(pad, np.float32)])
        u = np.asarray(self._dec(jnp.asarray(soft.reshape(
            -1, self.code.n_bits))))
        self.post("out", pmt.make_pdu(meta, u.reshape(-1).astype(np.uint8)))


# ---------------------------------------------------------------------------
# extended wiring (extended_encoder.py analog) + factories
# ---------------------------------------------------------------------------

def _parse_puncpat(puncpat: str):
    """Reference puncpat strings, e.g. '11011' (extended_encoder.py)."""
    bits = [c == "1" for c in puncpat]
    pat = 0
    for b in bits:
        pat = (pat << 1) | int(b)
    return len(bits), pat


def extended_encoder(code: GenericCode, puncpat: str | None = None):
    """Return the block chain [encoder(, puncture)] the reference's
    extended_encoder hier wires up (threading/capillary modes collapse —
    frames are already batched on device)."""
    from .fec import PunctureBB
    chain = [FecEncoder(code)]
    if puncpat and "0" in puncpat:
        size, pat = _parse_puncpat(puncpat)
        chain.append(PunctureBB(size, pat))
    return chain


def extended_decoder(code: GenericCode, puncpat: str | None = None):
    from .fec import DepunctureBB
    chain = []
    if puncpat and "0" in puncpat:
        size, pat = _parse_puncpat(puncpat)
        chain.append(DepunctureBB(size, pat, sym=0.0))
    chain.append(FecDecoder(code))
    return chain


def encoder(code, deployment: str = "streaming", **kw):
    """Uniform factory: fec.encoder(code, deployment=...)."""
    return {"streaming": FecEncoder, "tagged": FecTaggedEncoder,
            "async": FecAsyncEncoder}[deployment](code, **kw)


def decoder(code, deployment: str = "streaming", **kw):
    return {"streaming": FecDecoder, "tagged": FecTaggedDecoder,
            "async": FecAsyncDecoder}[deployment](code, **kw)


# ---------------------------------------------------------------------------
# BER curve harness (bercurve_generator / fec_test analog)
# ---------------------------------------------------------------------------

def ber_curve(code: GenericCode, esn0_db, frames: int = 64, seed: int = 0):
    """AWGN loopback BER at each Es/N0 (dB): encode random frames, BPSK map
    (bit b -> 1-2b), add noise, decode, count. Runs one jitted program per
    SNR point with all frames batched. Returns list of (esn0_db, ber)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (frames, code.k_bits)).astype(np.int8)

    @jax.jit
    def run(u_dev, noise):
        x = 1.0 - 2.0 * code.encode_frames(u_dev).astype(jnp.float32)
        soft = x + noise
        return code.decode_frames(soft)

    out = []
    for db in esn0_db:
        sigma = float(np.sqrt(0.5 * 10 ** (-db / 10.0) * 2.0))
        noise = rng.normal(0, sigma, (frames, code.n_bits)).astype(np.float32)
        dec = np.asarray(run(jnp.asarray(u), jnp.asarray(noise)))
        ber = float(np.mean(dec != u))
        out.append((float(db), ber))
    return out


class BercurveGenerator(Block):
    """fec_bercurve_generator (gr-fec/python/fec/bercurve_generator.py):
    0 inputs, 2*len(esno) unpacked-byte outputs — per Es/N0 point the
    (tx bits, decoded bits) pair of an AWGN BPSK loopback through the
    code. One jitted step encodes/corrupts/decodes ALL SNR points
    batched; the PRNG key is the carried state."""

    def __init__(self, code: GenericCode, esno, seed: int = 0, name=None):
        super().__init__(name)
        self.code = code
        self.esno = np.atleast_1d(np.asarray(esno, np.float64))
        self.seed = int(seed) & 0x7FFFFFFF
        self.in_ports = ()
        self.out_ports = tuple(PortSpec(B)
                               for _ in range(2 * self.esno.size))
        self.sigmas = np.sqrt(0.5 * 10 ** (-self.esno / 10.0) * 2.0
                              ).astype(np.float32)

    @property
    def in_rates(self):
        return ()

    @property
    def out_rates(self):
        return tuple(Fraction(self.code.k_bits)
                     for _ in range(2 * self.esno.size))

    def init_state(self):
        return jax.random.PRNGKey(self.seed)

    def apply(self, state, inputs, n_in):
        k = self.code.k_bits
        ne = self.esno.size
        key, k1, k2 = jax.random.split(state, 3)
        u = jax.random.bernoulli(k1, 0.5, (ne, k)).astype(jnp.int8)
        x = 1.0 - 2.0 * self.code.encode_frames(u).astype(jnp.float32)
        noise = jax.random.normal(k2, x.shape, jnp.float32) \
            * jnp.asarray(self.sigmas)[:, None]
        dec = self.code.decode_frames(x + noise)
        outs = []
        for i in range(ne):
            outs.append(u[i].astype(jnp.int8))
            outs.append(dec[i].astype(jnp.int8))
        return key, tuple(outs)


def bercurve_generator(encoder_list, decoder_list=None, esno=None,
                       samp_rate=None, threadtype=None, puncpat=None,
                       seed=0, **_):
    code = encoder_list
    if isinstance(code, (list, tuple)):
        code = code[0]
    if esno is None:
        esno = np.arange(0.0, 3.0, 0.25)
    return BercurveGenerator(code, esno, seed=abs(int(seed or 0)))
