"""gr-trellis GRC surface: block forms of the turbo kernels + the
`trellis.` / `fu.` (fsm_utils) namespace the reference's example graphs
evaluate their parameters in.

Reference parity:
  trellis.fsm(...)            gr-trellis/lib/fsm.cc — polymorphic ctor
                              (file path / I,S,O,NS,OS / mod_size,ch_len).
  trellis.interleaver(K,seed) gr-trellis/lib/interleaver.cc — random
                              permutation with INTER/DEINTER accessors.
  fsm_utils (fu.)             gr-trellis/python/trellis/fsm_utils.py —
                              (dimensionality, flat table) constellation
                              pairs + make_isi_lookup. Tables here are
                              re-derived from the standard definitions
                              (PAM/PSK grids, binary-indexed products), not
                              copied; orderings are self-consistent across
                              this module's encoders/decoders.
  pccc/sccc encoder + combined decoder blocks
                              gr-trellis/lib/{pccc,sccc}_encoder_impl.cc,
                              pccc_decoder_combined_blk_impl.cc — block
                              forms over ops/trellis_turbo kernels, whole
                              interleaver blocks per step, vmapped.
  blks2_error_rate            legacy grc-gnuradio error-rate hier: running
                              symbol/bit error fraction over a window.

Design notes: every block processes whole K-symbol code blocks per
step (output_multiple), so the turbo loops (static python loop of SISO
lax.scans) and Viterbi traceback batch across blocks via vmap.
"""
from __future__ import annotations

import builtins
import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block
from ..core.stream import PortSpec, B, S, I, F, C
from .trellis import (FSM, TRELLIS_EUCLIDEAN, TRELLIS_HARD_SYMBOL,
                      calc_metric, make_interleaver)
from . import trellis_turbo as TT

# SISO combining rules (trellis/siso_type.h)
TRELLIS_MIN_SUM = 200
TRELLIS_SUM_PRODUCT = 201

# FSM definition files (plain numeric tables): resolved from
# $GRTPU_FSM_FILE_DIRS (colon-separated) first, with the reference
# checkout's install locations as last-resort fallbacks so this machine's
# layout isn't baked into runtime behavior.
import os as _os

FSM_FILE_DIRS = tuple(
    [p for p in _os.environ.get("GRTPU_FSM_FILE_DIRS", "").split(":") if p]
    + [
        "/root/reference/gr-trellis/examples/python/fsm_files",
        "/root/reference/gr-trellis/python/trellis",
    ])


def fsm(*args):
    """Polymorphic trellis.fsm ctor (fsm.cc): fsm(path) / fsm(I,S,O,NS,OS)
    / fsm(mod_size, ch_length) / fsm(other_fsm)."""
    if len(args) == 1 and isinstance(args[0], FSM):
        return args[0]
    if len(args) == 1 and isinstance(args[0], str):
        path = args[0]
        for marker in ("@FSM_FILE_INSTALL_DIR@",):
            if marker in path:
                tail = path.split(marker, 1)[1].lstrip("/")
                for d in FSM_FILE_DIRS:
                    cand = os.path.join(d, tail)
                    if os.path.exists(cand):
                        return FSM.from_file(cand)
                raise FileNotFoundError(tail)
        if not os.path.exists(path):
            for d in FSM_FILE_DIRS:
                cand = os.path.join(d, os.path.basename(path))
                if os.path.exists(cand):
                    return FSM.from_file(cand)
        return FSM.from_file(path)
    if len(args) == 2:
        return FSM.interference_channel(int(args[0]), int(args[1]))
    if len(args) == 5:
        return FSM(int(args[0]), int(args[1]), int(args[2]),
                   np.asarray(args[3]).reshape(int(args[1]), int(args[0])),
                   np.asarray(args[4]).reshape(int(args[1]), int(args[0])))
    raise TypeError(f"fsm(): unsupported arguments {args!r}")


class Interleaver:
    """trellis.interleaver(K, seed): random permutation object with the
    reference's accessor methods (interleaver.h K()/INTER()/DEINTER())."""

    def __init__(self, K: int, seed: int = 0, table=None):
        self._K = int(K)
        self._inter = (np.asarray(table, np.int32) if table is not None
                       else make_interleaver(self._K, int(seed)))
        self._deinter = np.empty_like(self._inter)
        self._deinter[self._inter] = np.arange(self._K, dtype=np.int32)

    def K(self):
        return self._K

    def INTER(self):
        return self._inter

    def DEINTER(self):
        return self._deinter


def interleaver(K, seed=0):
    return Interleaver(K, seed)


# ---------------------------------------------------------------------------
# fsm_utils (fu.) constellation tables — re-derived standard grids
# ---------------------------------------------------------------------------

def _pam(n):
    return list(np.arange(-(n - 1), n, 2, dtype=np.float64))


pam2 = (1, _pam(2))
pam4 = (1, _pam(4))
pam8 = (1, _pam(8))
# 4-PSK as (re, im) pairs, counter-clockwise from +1
psk4 = (2, [float(v) for k in range(4)
            for v in (np.cos(np.pi * k / 2), np.sin(np.pi * k / 2))])
psk8 = (2, [float(v) for k in range(8)
            for v in (np.cos(np.pi * k / 4), np.sin(np.pi * k / 4))])
# binary antipodal per dimension, symbol index read MSB-first
psk2x2 = (2, [float(1 - 2 * ((o >> (1 - d)) & 1))
              for o in range(4) for d in range(2)])
psk2x3 = (3, [float(1 - 2 * ((o >> (2 - d)) & 1))
              for o in range(8) for d in range(3)])
# representative 3-tap ISI channel for the equalization examples
c_channel = [0.227, 0.460, 0.688]


def make_isi_lookup(mod, channel, normalize=False):
    """fsm_utils.make_isi_lookup analog: table[t] = sum_k c[k]*pts[digit_k]
    where t's base-I digits MSB-first match FSM.interference_channel's
    output convention (newest symbol in the top digit). Returns (1, flat)."""
    D, pts = mod
    if D != 1:
        raise ValueError("ISI lookup needs a 1-dimensional modulation")
    c = np.asarray(channel, np.float64)
    if normalize:
        c = c / np.sqrt(np.sum(c ** 2))
    L = len(c)
    I_ = len(pts)
    pts = np.asarray(pts, np.float64)
    table = np.zeros(I_ ** L, np.float64)
    for t in range(I_ ** L):
        rem = t
        digits = []
        for _ in range(L):
            digits.insert(0, rem % I_)
            rem //= I_
        table[t] = float(np.dot(c, pts[np.asarray(digits)]))
    return (1, list(table))


# ---------------------------------------------------------------------------
# block forms
# ---------------------------------------------------------------------------

_DT = {"b": B, "s": S, "i": I, "f": F, "c": C}


def _metric_table(table):
    """Observation tables may be real OR complex (QPSK points) — keep the
    dtype; calc_metric handles both."""
    arr = np.asarray(table)
    return arr.astype(np.complex64 if np.iscomplexobj(arr) else np.float64)


def _obs_dtype(ch):
    return _DT.get(str(ch)[:1], F)


class PcccEncoderBlock(Block):
    """trellis_pccc_encoder_xx: K data symbols -> K combined symbols."""

    def __init__(self, fsm1, fsm2, il, K=None, S01=0, S02=0, dtype=B,
                 name=None):
        super().__init__(name)
        self.fsm1, self.fsm2 = fsm(fsm1), fsm(fsm2)
        self.il = il if isinstance(il, Interleaver) else Interleaver(int(il))
        self.K = int(K or self.il.K())
        self.S01, self.S02 = int(S01), int(S02)
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)
        self.output_multiple = self.K

    def apply(self, state, inputs, n_in):
        x = inputs[0].astype(jnp.int32).reshape(-1, self.K)
        y = jax.vmap(lambda d: TT.pccc_encode(
            self.fsm1, self.fsm2, self.il.INTER(), d,
            self.S01, self.S02))(x)
        return state, (y.reshape(-1).astype(inputs[0].dtype),)


class PcccDecoderCombinedBlock(Block):
    """trellis_pccc_decoder_combined_xx: D-dim observations -> data
    symbols, `iterations` turbo rounds per K-block."""

    def __init__(self, fsm1, fsm2, il, K, table, dim=1,
                 metric_type=TRELLIS_EUCLIDEAN, iterations=10,
                 S01=0, SK1=-1, S02=0, SK2=-1, scaling=1.0,
                 in_dtype=F, out_dtype=B, name=None):
        super().__init__(name)
        self.fsm1, self.fsm2 = fsm(fsm1), fsm(fsm2)
        self.il = il if isinstance(il, Interleaver) else Interleaver(int(il))
        self.K = int(K or self.il.K())
        self.D = int(dim)
        O = self.fsm1.O * self.fsm2.O
        self.table = _metric_table(table).reshape(O, self.D)
        self.metric_type = metric_type
        self.iters = int(iterations)
        self.S01, self.SK1, self.S02, self.SK2 = (int(S01), int(SK1),
                                                  int(S02), int(SK2))
        self.scaling = float(scaling)
        self.in_ports = (PortSpec(in_dtype),)
        self.out_ports = (PortSpec(out_dtype),)
        self.output_multiple = self.K

    @property
    def in_rates(self):
        return (Fraction(self.D),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def apply(self, state, inputs, n_in):
        nblk = inputs[0].shape[0] // (self.K * self.D)
        obs = inputs[0].reshape(nblk, self.K * self.D)

        def one(o):
            m = calc_metric(o, self.table, self.table.shape[0], self.D,
                            self.metric_type) * self.scaling
            return TT.pccc_decode(self.fsm1, self.fsm2, self.il.INTER(), m,
                                  self.iters, self.S01, self.SK1,
                                  self.S02, self.SK2)

        dec = jax.vmap(one)(obs)
        return state, (dec.reshape(-1).astype(self.out_ports[0].dtype),)


class ScccEncoderBlock(Block):
    """trellis_sccc_encoder_xx: outer encode -> interleave -> inner."""

    def __init__(self, fsm_outer, fsm_inner, il, K=None, S0o=0, S0i=0,
                 dtype=B, name=None):
        super().__init__(name)
        self.fo, self.fi = fsm(fsm_outer), fsm(fsm_inner)
        self.il = il if isinstance(il, Interleaver) else Interleaver(int(il))
        self.K = int(K or self.il.K())
        self.S0o, self.S0i = int(S0o), int(S0i)
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)
        self.output_multiple = self.K

    def apply(self, state, inputs, n_in):
        x = inputs[0].astype(jnp.int32).reshape(-1, self.K)
        y = jax.vmap(lambda d: TT.sccc_encode(
            self.fo, self.fi, self.il.INTER(), d, self.S0o, self.S0i))(x)
        return state, (y.reshape(-1).astype(inputs[0].dtype),)


class ScccDecoderCombinedBlock(Block):
    """trellis_sccc_decoder_combined_xx: observations -> outer data."""

    def __init__(self, fsm_outer, fsm_inner, il, K, table, dim=1,
                 metric_type=TRELLIS_EUCLIDEAN, iterations=10,
                 S0o=0, SKo=-1, S0i=0, SKi=-1, scaling=1.0,
                 in_dtype=F, out_dtype=B, name=None):
        super().__init__(name)
        self.fo, self.fi = fsm(fsm_outer), fsm(fsm_inner)
        self.il = il if isinstance(il, Interleaver) else Interleaver(int(il))
        self.K = int(K or self.il.K())
        self.D = int(dim)
        self.table = _metric_table(table).reshape(self.fi.O, self.D)
        self.metric_type = metric_type
        self.iters = int(iterations)
        self.S0o, self.SKo, self.S0i, self.SKi = (int(S0o), int(SKo),
                                                  int(S0i), int(SKi))
        self.scaling = float(scaling)
        self.in_ports = (PortSpec(in_dtype),)
        self.out_ports = (PortSpec(out_dtype),)
        self.output_multiple = self.K

    @property
    def in_rates(self):
        return (Fraction(self.D),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def apply(self, state, inputs, n_in):
        nblk = inputs[0].shape[0] // (self.K * self.D)
        obs = inputs[0].reshape(nblk, self.K * self.D)

        def one(o):
            m = calc_metric(o, self.table, self.fi.O, self.D,
                            self.metric_type) * self.scaling
            return TT.sccc_decode(self.fo, self.fi, self.il.INTER(), m,
                                  self.iters, self.S0o, self.SKo,
                                  self.S0i, self.SKi)

        dec = jax.vmap(one)(obs)
        return state, (dec.reshape(-1).astype(self.out_ports[0].dtype),)


class SisoCombinedF(Block):
    """trellis_siso_combined_f (siso_combined_f_impl.cc): input 0 = a
    priori soft values on FSM input symbols (I floats/step), input 1 = raw
    observations (D floats/step); output = posterior soft values on FSM
    input (posti) or output (posto) symbols, whole K-step blocks."""

    def __init__(self, fsm_, K, table, dim=1, metric_type=TRELLIS_EUCLIDEAN,
                 S0=0, SK=-1, posti=True, scaling=1.0, name=None):
        super().__init__(name)
        self.fsm = fsm(fsm_)
        self.K = int(K)
        self.D = int(dim)
        self.table = _metric_table(table).reshape(self.fsm.O,
                                                  self.D)
        self.metric_type = metric_type
        self.S0, self.SK = int(S0), int(SK)
        self.posti = bool(posti)
        self.scaling = float(scaling)
        self.in_ports = (PortSpec(F), PortSpec(F))
        self.out_ports = (PortSpec(F),)
        self.nout_sym = self.fsm.I if self.posti else self.fsm.O
        self.output_multiple = self.K * self.nout_sym

    @property
    def in_rates(self):
        return (Fraction(self.fsm.I), Fraction(self.D))

    @property
    def out_rates(self):
        return (Fraction(self.nout_sym),)

    def apply(self, state, inputs, n_in):
        from .trellis import siso
        I_ = int(self.fsm.I)
        nblk = inputs[1].shape[0] // (self.K * self.D)
        pri = inputs[0].reshape(nblk, self.K, I_)
        obs = inputs[1].reshape(nblk, self.K * self.D)

        def one(pr, o):
            m = calc_metric(o, self.table, self.fsm.O, self.D,
                            self.metric_type) * self.scaling
            return siso(self.fsm, pr.astype(jnp.float32), m,
                        S0=self.S0, SK=self.SK,
                        posti=self.posti, posto=not self.posti)

        out = jax.vmap(one)(pri, obs)
        return state, (out.reshape(-1).astype(jnp.float32),)


class ErrorRateBlock(Block):
    """blks2_error_rate: running error fraction between a reference and a
    test symbol stream (legacy grc-gnuradio error_rate hier). One float per
    input symbol — the cumulative rate so far (windowed by carry)."""

    def __init__(self, mode="SER", win_size=1000, bits_per_symbol=1,
                 dtype=B, name=None):
        super().__init__(name)
        self.bits = int(bits_per_symbol)
        self.ber = str(mode).strip("'\"").upper() == "BER"
        self.in_ports = (PortSpec(dtype), PortSpec(dtype))
        self.out_ports = (PortSpec(F),)

    def init_state(self):
        return {"err": jnp.float32(0.0), "tot": jnp.float32(0.0)}

    def apply(self, state, inputs, n_in):
        a, b = inputs[0].astype(jnp.int32), inputs[1].astype(jnp.int32)
        if self.ber:
            diff = a ^ b
            e = sum((diff >> k) & 1 for k in range(self.bits)).astype(
                jnp.float32)
            per = float(self.bits)
        else:
            e = (a != b).astype(jnp.float32)
            per = 1.0
        cum_e = state["err"] + jnp.cumsum(e)
        cum_t = state["tot"] + jnp.arange(1, a.shape[0] + 1,
                                          dtype=jnp.float32) * per
        out = cum_e / jnp.maximum(cum_t, 1.0)
        return ({"err": cum_e[-1], "tot": cum_t[-1]},
                (out.astype(jnp.float32),))


# ---------------------------------------------------------------------------
# grc factories
# ---------------------------------------------------------------------------

def trellis_pccc_encoder_xx(o_fsm_args, i_fsm_args, interleaver_args,
                            o_init_state=0, i_init_state=0, bl=None,
                            type="bb", **_):
    return PcccEncoderBlock(o_fsm_args, i_fsm_args, interleaver_args,
                            bl, o_init_state, i_init_state,
                            _obs_dtype(type))


def trellis_pccc_decoder_combined_xx(o_fsm_args, i_fsm_args, interleaver,
                                     block_size, table, dim=1,
                                     metric_type=TRELLIS_EUCLIDEAN,
                                     iterations=10, o_init_state=0,
                                     o_final_state=-1, i_init_state=0,
                                     i_final_state=-1, scaling=1.0,
                                     type="f", out_type="b", **_):
    return PcccDecoderCombinedBlock(
        o_fsm_args, i_fsm_args, interleaver, block_size, table, dim,
        metric_type, iterations, o_init_state, o_final_state,
        i_init_state, i_final_state, scaling,
        _obs_dtype(type), _obs_dtype(out_type))


def trellis_sccc_encoder_xx(o_fsm_args, i_fsm_args, interleaver_args,
                            o_init_state=0, i_init_state=0, bl=None,
                            type="bb", **_):
    return ScccEncoderBlock(o_fsm_args, i_fsm_args, interleaver_args,
                            bl, o_init_state, i_init_state,
                            _obs_dtype(type))


def trellis_sccc_decoder_combined_xx(o_fsm_args, i_fsm_args, interleaver,
                                     block_size, table, dim=1,
                                     metric_type=TRELLIS_EUCLIDEAN,
                                     iterations=10, o_init_state=0,
                                     o_final_state=-1, i_init_state=0,
                                     i_final_state=-1, scaling=1.0,
                                     type="f", out_type="b", **_):
    return ScccDecoderCombinedBlock(
        o_fsm_args, i_fsm_args, interleaver, block_size, table, dim,
        metric_type, iterations, o_init_state, o_final_state,
        i_init_state, i_final_state, scaling,
        _obs_dtype(type), _obs_dtype(out_type))


def trellis_siso_combined_f(fsm_args, block_size, table, dim=1,
                            metric_type=TRELLIS_EUCLIDEAN, init_state=0,
                            final_state=-1, a_post_in=True,
                            a_post_out=False, scaling=1.0, **_):
    # POSTI/POSTO (siso_type.h): posterior side is the one whose a-post
    # flag is set; POSTI wins when only a_post_in is set (the
    # turbo-equalization usage: priors+posteriors both on FSM inputs)
    posti = str(a_post_out).strip() not in ("True", "true", "1")
    return SisoCombinedF(fsm_args, block_size, table, dim, metric_type,
                         init_state, final_state, posti, scaling)


def blks2_error_rate(type="SER", win_size=1000, bits_per_symbol=1, **_):
    return ErrorRateBlock(type, win_size, bits_per_symbol)


def trellis_encoder_xx(fsm_args, init_state=0, type="bb", **_):
    from .trellis import TrellisEncoder
    b = TrellisEncoder(fsm(fsm_args), int(init_state),
                       _obs_dtype(str(type)[:1]))
    b.out_ports = (PortSpec(_obs_dtype(str(type)[1:2] or str(type)[:1])),)
    return b


def trellis_metrics_x(card, table, dim=1, metric_type=TRELLIS_EUCLIDEAN,
                      type="f", **_):
    from .trellis import TrellisMetrics
    return TrellisMetrics(int(card), int(dim), table, metric_type,
                          _obs_dtype(type))


def trellis_viterbi_x(fsm_args, block_size, init_state=-1, final_state=-1,
                      type="b", **_):
    from .trellis import TrellisViterbi
    return TrellisViterbi(fsm(fsm_args), int(block_size), int(init_state),
                          int(final_state), _obs_dtype(type))


def trellis_viterbi_combined_xx(fsm_args, block_size, table, dim=1,
                                metric_type=TRELLIS_EUCLIDEAN,
                                init_state=-1, final_state=-1,
                                type="f", out_type="b", **_):
    from .trellis import TrellisViterbiCombined
    return TrellisViterbiCombined(fsm(fsm_args), int(block_size),
                                  int(init_state), int(final_state),
                                  int(dim), table, metric_type,
                                  _obs_dtype(type), _obs_dtype(out_type))


def trellis_permutation(interleaver_size, table, syms_per_block=1,
                        type="byte", **_):
    from .trellis import Permutation
    dt = {"byte": B, "short": S, "int": I, "float": F, "complex": C,
          float: F, complex: C, int: I}.get(
              type if isinstance(type, builtins.type) else str(type), B)
    return Permutation(int(interleaver_size), np.asarray(table, np.int64),
                       int(syms_per_block), dt)
