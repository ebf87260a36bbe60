"""gr-trellis: FSM-based coded modulation — encoder, Viterbi, SISO (BCJR).

Reference behavior (NOT copied; reimplemented):
  gr-trellis/lib/fsm.cc            — FSM table construction (generator-matrix
                                     constructor at :116, file format at :71,
                                     PS/PI tables via generate_PS_PI)
  gr-trellis/lib/base.cc           — MSB-first digit codecs (dec2base etc.)
  gr-trellis/lib/core_algorithms.cc:29-140  — viterbi_algorithm (ACS loop,
                                     per-step min normalization, traceback)
  gr-trellis/lib/core_algorithms.cc siso_algorithm — forward/backward
                                     min / min* recursions
  gr-trellis/lib/calc_metric.cc    — TRELLIS_EUCLIDEAN / HARD_SYMBOL metrics

Design: the reference runs a scalar triple loop (time x next-state x
predecessor). Here the state dimension is a *vector axis*: the ACS step is a
gather over dense predecessor tables [S, P] plus a min-reduce, and time is a
`lax.scan`. S=64..8192 states ride vector lanes; independent K-symbol blocks
batch via vmap. Traceback is a reverse scan over the stored decisions.

All FSM table construction is host-side NumPy (done once at graph build);
only the per-sample recursions run on device.
"""
from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block
from ..core.stream import PortSpec, B, C, F, I as I32

INF = 1.0e9

# metric types (gr-digital/include/gnuradio/digital/metric_type.h)
TRELLIS_EUCLIDEAN = 200
TRELLIS_HARD_SYMBOL = 201
TRELLIS_HARD_BIT = 202


def _dec2base_msb(num: int, base: int, ndigits: int) -> np.ndarray:
    """MSB-first digits of num in `base` (base.cc dec2base)."""
    out = np.zeros(ndigits, np.int64)
    n = num
    for i in range(ndigits):
        out[ndigits - 1 - i] = n % base
        n //= base
    if n:
        raise ValueError(f"{num} needs more than {ndigits} base-{base} digits")
    return out


class FSM:
    """Finite state machine with I inputs, S states, O outputs.

    NS[s, i] = next state, OS[s, i] = output symbol (fsm.h:44-49).
    Dense predecessor tables for the vectorized ACS:
      PS[j, p]      = p-th predecessor state of state j
      PI[j, p]      = input symbol taken from that predecessor
      PRED_OS[j, p] = OS[PS[j,p], PI[j,p]]
      PMASK[j, p]   = 0.0 for real transitions, +INF for padding
    Predecessors are enumerated in (state-major, input-minor) order to match
    the reference's generate_PS_PI tie-breaking in the strict-< ACS compare.
    """

    def __init__(self, I: int, S: int, O: int, NS, OS):
        # callable ints: GRC expressions use the reference's accessor-method
        # syntax (fsm.I()/fsm.S()/fsm.O(), fsm.h:51-53)
        class _CInt(int):
            def __call__(self):
                return int(self)

        self.I, self.S, self.O = _CInt(int(I)), _CInt(int(S)), _CInt(int(O))
        self.NS = np.asarray(NS, np.int32).reshape(self.S, self.I)
        self.OS = np.asarray(OS, np.int32).reshape(self.S, self.I)
        if self.NS.min() < 0 or self.NS.max() >= self.S:
            raise ValueError("NS entries out of range")
        if self.OS.min() < 0 or self.OS.max() >= self.O:
            raise ValueError("OS entries out of range")
        self._build_pred_tables()

    # ---- constructors ----
    @classmethod
    def from_generator(cls, k: int, n: int, G) -> "FSM":
        """Rate k/n FSM from a k*n octal-free generator matrix of integers
        (fsm.cc:116). G[i*n+j] is the polynomial from input register i to
        output j, MSB = newest bit ("1+D is 110, not 011")."""
        G = np.asarray(G, np.int64).reshape(k, n)
        max_mem_x = np.full(k, -1, np.int64)
        for i in range(k):
            for j in range(n):
                if G[i, j] != 0:
                    mem = int(math.log2(G[i, j]))
                    max_mem_x[i] = max(max_mem_x[i], mem)
        max_mem = int(max_mem_x.max())
        sum_max_mem = int(max_mem_x.sum())
        I_, S_, O_ = 1 << k, 1 << sum_max_mem, 1 << n
        bases_x = [1 << int(m) for m in max_mem_x]
        # binary (MSB-first) generator rows, width max_mem+1
        Gb = np.zeros((k, n, max_mem + 1), np.int64)
        for i in range(k):
            for j in range(n):
                Gb[i, j] = _dec2base_msb(int(G[i, j]), 2, max_mem + 1)
        NS = np.zeros((S_, I_), np.int32)
        OS = np.zeros((S_, I_), np.int32)
        for s in range(S_):
            # split s into k shift registers, mixed radix, MSB-first
            sx, rem = [], s
            for j in range(k - 1, -1, -1):
                sx.insert(0, rem % bases_x[j])
                rem //= bases_x[j]
            for i in range(I_):
                inb = _dec2base_msb(i, 2, k)
                nsx = [(int(inb[j]) * bases_x[j] + sx[j]) // 2 for j in range(k)]
                ns = 0
                for j in range(k):
                    ns = ns * bases_x[j] + nsx[j]
                NS[s, i] = ns
                out = 0
                for nn in range(n):
                    bit = 0
                    for j in range(k):
                        tx = int(inb[j]) * bases_x[j] + sx[j]
                        tb = _dec2base_msb(tx, 2, max_mem + 1)
                        bit = (bit + int((Gb[j, nn] * tb).sum())) % 2
                    out = out * 2 + bit
                OS[s, i] = out
        return cls(I_, S_, O_, NS, OS)

    @classmethod
    def from_file(cls, path: str) -> "FSM":
        """Text format (fsm.cc:71): 'I S O' then NS rows then OS rows."""
        toks = []
        with open(path) as f:
            for line in f:
                line = line.split("#")[0]
                fields = line.split()
                if fields and not all(
                        t.lstrip("-").isdigit() for t in fields):
                    break       # free-text trailer after the tables
                toks += [int(t) for t in fields]
        I_, S_, O_ = toks[0], toks[1], toks[2]
        body = toks[3:]
        NS = body[: S_ * I_]
        OS = body[S_ * I_: 2 * S_ * I_]
        return cls(I_, S_, O_, NS, OS)

    @classmethod
    def interference_channel(cls, mod_size: int, ch_length: int) -> "FSM":
        """ISI-channel FSM (fsm.cc:228): I=mod_size, S=mod_size^(L-1)."""
        I_ = mod_size
        S_ = int(round(mod_size ** (ch_length - 1)))
        O_ = S_ * I_
        NS = np.zeros((S_, I_), np.int32)
        OS = np.zeros((S_, I_), np.int32)
        for s in range(S_):
            for i in range(I_):
                t = i * S_ + s
                NS[s, i] = t // mod_size
                OS[s, i] = t
        return cls(I_, S_, O_, NS, OS)

    def _build_pred_tables(self):
        preds = [[] for _ in range(self.S)]
        for s in range(self.S):
            for i in range(self.I):
                preds[self.NS[s, i]].append((s, i))
        P = max(1, max(len(p) for p in preds))
        self.P = P
        self.PS = np.zeros((self.S, P), np.int32)
        self.PI = np.zeros((self.S, P), np.int32)
        self.PRED_OS = np.zeros((self.S, P), np.int32)
        self.PMASK = np.full((self.S, P), INF, np.float32)
        for j in range(self.S):
            for p, (s, i) in enumerate(preds[j]):
                self.PS[j, p] = s
                self.PI[j, p] = i
                self.PRED_OS[j, p] = self.OS[s, i]
                self.PMASK[j, p] = 0.0

    def write_fsm_txt(self, path: str):
        with open(path, "w") as f:
            f.write(f"{self.I} {self.S} {self.O}\n\n")
            for row in self.NS:
                f.write(" ".join(map(str, row)) + "\n")
            f.write("\n")
            for row in self.OS:
                f.write(" ".join(map(str, row)) + "\n")


# ---------------------------------------------------------------------------
# device-side core algorithms
# ---------------------------------------------------------------------------

def calc_metric(obs, table, O: int, D: int, metric_type=TRELLIS_EUCLIDEAN):
    """Per-symbol branch metrics (calc_metric.cc TRELLIS_EUCLIDEAN /
    HARD_SYMBOL). obs: [K*D] (real or complex) -> [K, O] float32.
    table: [O, D] modulation table."""
    obs = jnp.reshape(obs, (-1, 1, D))
    tab = jnp.reshape(jnp.asarray(table), (1, O, D))
    d = obs - tab
    met = jnp.sum((d * jnp.conj(d)).real if jnp.iscomplexobj(d) else d * d,
                  axis=-1).astype(jnp.float32)               # [K, O]
    if metric_type == TRELLIS_EUCLIDEAN:
        return met
    if metric_type == TRELLIS_HARD_SYMBOL:
        best = jnp.argmin(met, axis=-1, keepdims=True)
        o_ids = jax.lax.broadcasted_iota(jnp.int32, met.shape, 1)
        return jnp.where(o_ids == best, 0.0, 1.0).astype(jnp.float32)
    raise NotImplementedError("TRELLIS_HARD_BIT not implemented (matches "
                              "reference which throws too)")


def _alpha0(fsm: FSM, S0: int):
    if S0 < 0:
        return jnp.zeros(fsm.S, jnp.float32)
    return jnp.full((fsm.S,), INF, jnp.float32).at[S0].set(0.0)


def _radix_tables(fsm: FSM, R: int):
    """R-step composed predecessor tables (host NumPy, cached on the FSM).

    PS_R[j, p]      : start state of the p-th R-step path ending at j
    OUT_R[j, p, k]  : output symbol of step k (k=0 earliest) along path p
    PACK_R[j, p]    : PS_R | (packed input symbols << 16), inputs packed
                      little-endian in I (sum_k i_k * I^k)
    PMASK_R[j, p]   : INF where the path uses a masked (nonexistent) edge

    Candidate ordering p = sum_k p_k * P^(k-1) with the EARLIEST step in
    the least-significant digit: argmin's first-min tie-break then matches
    the sequential ACS exactly (the final step's choice is the major key,
    recursively, which is how the per-step argmin collapses ties)."""
    key = ("_radix", R)
    cache = getattr(fsm, "_radix_cache", None)
    if cache is None:
        cache = fsm._radix_cache = {}
    if key in cache:
        return cache[key]
    S, P, I_ = fsm.S, fsm.P, fsm.I
    PR = P ** R
    PS_R = np.zeros((S, PR), np.int32)
    OUT_R = np.zeros((S, PR, R), np.int32)
    IN_R = np.zeros((S, PR, R), np.int64)
    PMASK_R = np.zeros((S, PR), np.float32)
    # recursive composition: path index p = p_last * P^(R-1) + prefix_idx
    for j in range(S):
        for p in range(PR):
            digs = []
            q = p
            for _ in range(R):
                digs.append(q % P)
                q //= P
            # digs[k] = choice at step k+1 (earliest first)
            st = j
            mask = 0.0
            for k in range(R - 1, -1, -1):  # walk backwards from the end
                pk = digs[k]
                mask += float(fsm.PMASK[st, pk])
                OUT_R[j, p, k] = fsm.PRED_OS[st, pk]
                IN_R[j, p, k] = fsm.PI[st, pk]
                st = fsm.PS[st, pk]
            PS_R[j, p] = st
            PMASK_R[j, p] = INF if mask > 0 else 0.0
    packin = np.zeros((S, PR), np.int64)
    for k in range(R):
        packin += IN_R[..., k] * (I_ ** k)    # base-I digits, exact sum
    PACK_R = (PS_R.astype(np.int64) | (packin << 16)).astype(np.int32)
    cache[key] = (PS_R, OUT_R, PACK_R, PMASK_R)
    return cache[key]


def _viterbi_path_radix(fsm: FSM, metrics, S0: int, SK: int, R: int):
    """viterbi_path with R trellis steps folded into each scan step:
    P^R candidate paths per state, one argmin — identical decisions and
    tie-breaks to the sequential ACS (see _radix_tables), but the two
    length-K scans shrink to K/R (both the ACS and the traceback step cost
    is dominated by per-step loop overheads at streaming sizes, not
    FLOPs)."""
    K = metrics.shape[0]
    PS_R, OUT_R, PACK_R, PMASK_R = _radix_tables(fsm, R)
    S, PR = PS_R.shape
    O = fsm.O
    I_ = fsm.I
    # Both per-step gathers (alpha[PS_R] and mR[k][OUT_R[k]]) are
    # tiny-table/big-index gathers. Re-express them as ONE-HOT MATMULS
    # instead: exact under precision=HIGHEST, and the whole candidate
    # build becomes two small matmuls + adds.
    A = np.zeros((S, S * PR), np.float32)     # alpha spread
    A[PS_R.reshape(-1), np.arange(S * PR)] = 1.0
    Bm = np.zeros((R * O, S * PR), np.float32)  # metric mixing
    for k in range(R):
        Bm[k * O + OUT_R[:, :, k].reshape(-1), np.arange(S * PR)] += 1.0
    PACKj = jnp.asarray(PACK_R)
    PMASK_flat = PMASK_R.reshape(-1)
    HI = jax.lax.Precision.HIGHEST

    def acs(alpha, mR):                       # mR: (R, O)
        z = (jnp.matmul(alpha, A, precision=HI)
             + jnp.matmul(mR.reshape(-1), Bm, precision=HI)
             + PMASK_flat)
        cand = z.reshape(S, PR)
        minmi = jnp.argmin(cand, axis=1).astype(jnp.int32)
        prange = jax.lax.broadcasted_iota(jnp.int32, PACKj.shape, 1)
        pk = jnp.sum(jnp.where(prange == minmi[:, None], PACKj, 0), axis=1)
        minm = jnp.min(cand, axis=1)
        minm = minm - jnp.min(minm)
        return minm, pk

    alpha_k, packed = jax.lax.scan(acs, _alpha0(fsm, S0),
                                   metrics.reshape(K // R, R, -1))
    st0 = jnp.argmin(alpha_k).astype(jnp.int32) if SK < 0 else jnp.int32(SK)

    def tb(st, pk):
        v = pk[st]
        code = v >> 16
        syms = jnp.stack([(code // (I_ ** k)) % I_ for k in range(R)])
        return v & 0xFFFF, syms

    _, out = jax.lax.scan(tb, st0, packed, reverse=True)
    return out.reshape(-1).astype(jnp.int32)


def viterbi_path(fsm: FSM, metrics, S0: int = 0, SK: int = -1,
                 radix: int = 1):
    """Viterbi over one K-symbol block (core_algorithms.cc:29-101).
    metrics: [K, O] float32 -> decoded input symbols [K] int32.
    Vectorized ACS: candidates via predecessor gathers, min over P axis.
    radix > 1 folds that many trellis steps per scan step (exact — see
    _viterbi_path_radix) when K divides and the candidate fan P^radix
    stays sane."""
    if radix > 1 and metrics.shape[0] % radix == 0 \
            and fsm.P ** radix * fsm.S <= 1 << 14:
        return _viterbi_path_radix(fsm, metrics, S0, SK, radix)
    PS = jnp.asarray(fsm.PS)
    PI = jnp.asarray(fsm.PI)
    PRED_OS = jnp.asarray(fsm.PRED_OS)
    PMASK = jnp.asarray(fsm.PMASK)

    # Survivor (input, prev_state) pairs are packed per (k, state) INSIDE
    # the ACS step as a P-way select over the precomputed [S, P] table —
    # avoiding a huge post-hoc [K, S]-indexed gather from PI/PS (gathers
    # with large index arrays from tiny tables; selects vectorize).
    PACK = (PI << 16) | PS                             # [S, P] int32

    def acs(alpha, m):
        cand = alpha[PS] + m[PRED_OS] + PMASK          # [S, P]
        minmi = jnp.argmin(cand, axis=1).astype(jnp.int32)
        prange = jax.lax.broadcasted_iota(jnp.int32, PACK.shape, 1)
        pk = jnp.sum(jnp.where(prange == minmi[:, None], PACK, 0), axis=1)
        minm = jnp.min(cand, axis=1)
        minm = minm - jnp.min(minm)                    # per-step normalization
        return minm, pk

    alpha_k, packed = jax.lax.scan(acs, _alpha0(fsm, S0), metrics)  # [K,S]

    st0 = jnp.argmin(alpha_k).astype(jnp.int32) if SK < 0 else jnp.int32(SK)

    # Traceback: sequential by nature, but the body is a single tiny
    # gather per step. (A log-depth associative composition of survivor
    # maps and a grouped-unroll variant are the alternatives.)
    def tb(st, pk):
        v = pk[st]
        return v & 0xFFFF, v >> 16

    _, out = jax.lax.scan(tb, st0, packed, reverse=True)
    return out.astype(jnp.int32)


def viterbi_combined(fsm: FSM, table, D: int, metric_type, obs,
                     S0: int = 0, SK: int = -1, radix: int = 1):
    """Fused metric computation + Viterbi (viterbi_algorithm_combined,
    core_algorithms.cc:142+). obs: [K*D] -> symbols [K]."""
    met = calc_metric(obs, table, fsm.O, D, metric_type)
    return viterbi_path(fsm, met, S0, SK, radix=radix)


def _combine(a, b, use_min_star: bool):
    if use_min_star:
        m = jnp.minimum(a, b)
        return m - jnp.log1p(jnp.exp(-jnp.abs(a - b)))
    return jnp.minimum(a, b)


def siso(fsm: FSM, priori, prioro, S0: int = 0, SK: int = -1,
         posti: bool = True, posto: bool = False, use_min_star: bool = True):
    """SISO (BCJR in the min/min* domain) — core_algorithms.cc
    siso_algorithm. priori: [K, I] input priors, prioro: [K, O] observation
    metrics; returns posterior metrics [K, I] and/or [K, O] (lower=better).
    Forward+backward are two scans; the combining step is a batched gather.
    """
    S, I_, O = fsm.S, fsm.I, fsm.O
    PS, PI = jnp.asarray(fsm.PS), jnp.asarray(fsm.PI)
    PRED_OS, PMASK = jnp.asarray(fsm.PRED_OS), jnp.asarray(fsm.PMASK)
    NS, OS = jnp.asarray(fsm.NS), jnp.asarray(fsm.OS)

    def fwd(alpha, km):
        pi_, po_ = km
        cand = alpha[PS] + pi_[PI] + po_[PRED_OS] + PMASK
        if use_min_star:
            m = cand[:, 0]
            for p in range(1, fsm.P):
                m = _combine(m, cand[:, p], True)
        else:
            m = jnp.min(cand, axis=1)
        m = m - jnp.min(m)
        return m, alpha  # output PRE-update alpha[k]

    alpha_K, alphas = jax.lax.scan(fwd, _alpha0(fsm, S0), (priori, prioro))
    # alphas[k] = alpha at time k (before consuming symbol k); also need final
    # beta init
    if SK < 0:
        betaK = jnp.zeros(S, jnp.float32)
    else:
        betaK = jnp.full((S,), INF, jnp.float32).at[SK].set(0.0)

    def bwd(beta, km):
        pi_, po_ = km
        # beta[k][j] = combine_i beta[k+1][NS[j,i]] + priori[k,i] + prioro[k,OS[j,i]]
        cand = beta[NS] + pi_[None, :] + po_[OS]       # [S, I]
        if use_min_star:
            m = cand[:, 0]
            for i in range(1, I_):
                m = _combine(m, cand[:, i], True)
        else:
            m = jnp.min(cand, axis=1)
        m = m - jnp.min(m)
        return m, m  # output beta[k]

    _, betas = jax.lax.scan(bwd, betaK, (priori, prioro), reverse=True)
    # betas[k] = beta at time k; beta_{k+1} needed for combining:
    betas_next = jnp.concatenate([betas[1:], betaK[None]], axis=0)  # [K, S]

    outs = []
    if posti:
        # post_i[k, i] = combine_j alpha[k, j] + prioro[k, OS[j,i]] + beta[k+1, NS[j,i]]
        def comb_i(al, bn, po_):
            cand = al[:, None] + po_[OS] + bn[NS]      # [S, I]
            if use_min_star:
                m = cand[0]
                for j in range(1, S):
                    m = _combine(m, cand[j], True)
            else:
                m = jnp.min(cand, axis=0)
            return m - jnp.min(m)
        outs.append(jax.vmap(comb_i)(alphas, betas_next, prioro))
    if posto:
        onehot = jnp.asarray(
            np.eye(O, dtype=np.float32)[fsm.OS.reshape(-1)].reshape(S, I_, O))

        def comb_o(al, bn, pi_):
            base = al[:, None] + pi_[None, :] + bn[NS]  # [S, I]
            cand = jnp.where(onehot > 0, base[:, :, None], INF)  # [S, I, O]
            cand = cand.reshape(S * I_, O)
            if use_min_star:
                m = cand[0]
                for j in range(1, S * I_):
                    m = _combine(m, cand[j], True)
            else:
                m = jnp.min(cand, axis=0)
            return m - jnp.min(m)
        outs.append(jax.vmap(comb_o)(alphas, betas_next, priori))
    return outs[0] if len(outs) == 1 else tuple(outs)


def encode_fsm(fsm: FSM, symbols, S0: int = 0):
    """Trellis encode: input symbols [K] -> output symbols [K]
    (gr-trellis/lib/encoder_impl.cc). Sequential scan (cheap: one gather per
    symbol); independent blocks batch with vmap."""
    NS, OS = jnp.asarray(fsm.NS), jnp.asarray(fsm.OS)

    def step(s, i):
        return NS[s, i], OS[s, i]

    _, out = jax.lax.scan(step, jnp.int32(S0), symbols.astype(jnp.int32))
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class TrellisEncoder(Block):
    """trellis.encoder_XX: input symbol stream -> output symbol stream."""

    def __init__(self, fsm: FSM, S0: int = 0, dtype=B, name=None):
        super().__init__(name)
        self.fsm, self.S0 = fsm, int(S0)
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)

    def init_state(self):
        return {"s": jnp.int32(self.S0)}

    def apply(self, state, inputs, n_in):
        NS, OS = jnp.asarray(self.fsm.NS), jnp.asarray(self.fsm.OS)

        def step(s, i):
            return NS[s, i], OS[s, i]

        s, out = jax.lax.scan(step, state["s"], inputs[0].astype(jnp.int32))
        return {"s": s}, (out.astype(inputs[0].dtype),)


class TrellisMetrics(Block):
    """trellis.metrics_X: observation stream -> O branch metrics per symbol
    (1:O interpolating over D-dim observations)."""

    def __init__(self, fsm_O: int, D: int, table, metric_type=TRELLIS_EUCLIDEAN,
                 in_dtype=C, name=None):
        super().__init__(name)
        self.O, self.D = int(fsm_O), int(D)
        self.table = np.asarray(table).reshape(self.O, self.D)
        self.metric_type = metric_type
        self.in_ports = (PortSpec(in_dtype),)
        self.out_ports = (PortSpec(F),)

    @property
    def in_rates(self):
        return (Fraction(self.D),)

    @property
    def out_rates(self):
        return (Fraction(self.O),)

    def apply(self, state, inputs, n_in):
        met = calc_metric(inputs[0], self.table, self.O, self.D,
                          self.metric_type)
        return state, (met.reshape(-1),)


class TrellisViterbi(Block):
    """trellis.viterbi_X: metric stream (O floats/symbol) -> decoded symbols,
    in independent K-symbol blocks (matches the reference block's
    set_output_multiple(K) + fresh S0/SK per block)."""

    def __init__(self, fsm: FSM, K: int, S0: int = 0, SK: int = -1,
                 out_dtype=B, name=None):
        super().__init__(name)
        self.fsm, self.K, self.S0, self.SK = fsm, int(K), int(S0), int(SK)
        self.in_ports = (PortSpec(F),)
        self.out_ports = (PortSpec(out_dtype),)
        self.output_multiple = self.K

    @property
    def in_rates(self):
        return (Fraction(self.fsm.O),)

    @property
    def out_rates(self):
        return (Fraction(1),)

    def apply(self, state, inputs, n_in):
        nsym = inputs[0].shape[0] // self.fsm.O
        nblk = nsym // self.K
        met = inputs[0].reshape(nblk, self.K, self.fsm.O)
        dec = jax.vmap(lambda m: viterbi_path(self.fsm, m, self.S0, self.SK))(met)
        return state, (dec.reshape(-1).astype(self.out_ports[0].dtype),)


class TrellisViterbiCombined(Block):
    """trellis.viterbi_combined_XX: observations -> decoded symbols (fused
    metrics + Viterbi)."""

    def __init__(self, fsm: FSM, K: int, S0: int, SK: int, D: int, table,
                 metric_type=TRELLIS_EUCLIDEAN, in_dtype=C, out_dtype=B,
                 name=None):
        super().__init__(name)
        self.fsm, self.K, self.S0, self.SK = fsm, int(K), int(S0), int(SK)
        self.D = int(D)
        self.table = np.asarray(table).reshape(fsm.O, self.D)
        self.metric_type = metric_type
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
        nsym = inputs[0].shape[0] // self.D
        nblk = nsym // self.K
        obs = inputs[0].reshape(nblk, self.K * self.D)
        dec = jax.vmap(lambda o: viterbi_combined(
            self.fsm, self.table, self.D, self.metric_type, o,
            self.S0, self.SK))(obs)
        return state, (dec.reshape(-1).astype(self.out_ports[0].dtype),)


class Permutation(Block):
    """trellis.permutation: fixed K-periodic permutation of SYMS-item groups
    (gr-trellis/lib/permutation_impl.cc). interleaver=TABLE maps out[i] =
    in[TABLE[i]] within each K-group."""

    def __init__(self, K: int, table, syms_per_block: int = 1, dtype=B,
                 name=None):
        super().__init__(name)
        self.K = int(K)
        self.table = np.asarray(table, np.int32)
        self.spb = int(syms_per_block)
        self.in_ports = (PortSpec(dtype),)
        self.out_ports = (PortSpec(dtype),)
        self.output_multiple = self.K * self.spb

    def apply(self, state, inputs, n_in):
        x = inputs[0].reshape(-1, self.K, self.spb)
        y = x[:, jnp.asarray(self.table), :]
        return state, (y.reshape(-1),)


def make_interleaver(K: int, seed: int = 0):
    """Random interleaver table (gr-trellis/lib/interleaver.cc)."""
    rng = np.random.default_rng(seed)
    return rng.permutation(K).astype(np.int32)
