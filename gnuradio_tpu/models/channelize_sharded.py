"""Channel-axis-sharded PFB channelizer + per-channel arb resampler.

The multi-chip form of BASELINE.json config #2 (SURVEY.md §7 step 4 names
BOTH time- and channel-axis sharding; wfm_sharded.py covers time, this
covers chan): the M polyphase arms AND the M output channels are partitioned
across the "chan" mesh axis. Each chip:

  1. builds its Mloc = M/D arm signals from the (replicated) input chunk —
     pure strided reshapes, no comm;
  2. runs its arm FIRs (one batched matmul);
  3. computes every chip's channel contributions from its own arms as ONE
     DFT matmul  E[c, m_local] @ V_local  (the IFFT across arms becomes a
     dense matmul because arms are distributed);
  4. psum_scatter over "chan" sums the partial DFTs and leaves each chip
     exactly its own channel block — the ONLY bulk collective, moving
     (D-1)/D of one chunk per step between devices;
  5. runs its channels' arb resamplers locally (batched gather + two dots).

Reference: gr-filter/lib/pfb_channelizer_ccf_impl.cc (+ pfb_arb_resampler),
distributed the way the reference farms independent channels to threads
(scheduler_tpb one-thread-per-block over per-channel sub-chains).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..kernels.fir_xla import fir_apply_batched
from .channelize import channelizer_taps, resampler_taps
from ..ops.pfb import PfbArbResampler, _pad_arms


def make_channelizer_sharded(mesh: Mesh, fs: float = 6_400_000.0,
                             nchans: int = 64,
                             resample_rate: float | None = 0.9375,
                             nfilts: int = 32):
    """Returns (init_state, step, specs).

    step(state, iq_f32) -> (state, out_f32) with iq_f32 (n, 2) float32
    REPLICATED (every chip sees the full chunk; the commutator needs all
    input phases) and out (nchans, T_out, 2) float32 sharded on "chan".
    """
    M = int(nchans)
    D = mesh.shape["chan"]
    assert M % D == 0, "nchans must divide across the chan axis"
    Mloc = M // D
    arms_np = _pad_arms(np.real(channelizer_taps(fs, M)).astype(np.float32), M)
    L = arms_np.shape[1]
    ch_rate = fs / M
    rs = None
    if resample_rate is not None:
        rs = PfbArbResampler(resample_rate,
                             resampler_taps(ch_rate, resample_rate, nfilts),
                             nfilts)
    in_mult = M * (rs.Q if rs is not None else 1) * D

    # DFT matrix rows: channel c from arm m: e^{+2pi j c m / M} (the M*ifft
    # convention of ops/pfb.PfbChannelizer)
    c_ix = np.arange(M)[:, None]
    m_ix = np.arange(M)[None, :]
    E_full = np.exp(2j * np.pi * c_ix * m_ix / M).astype(np.complex64)

    def init_state():
        st = {"tail": jnp.zeros((L * M - 1,), jnp.complex64)}
        if rs is not None:
            st["rs"] = jnp.zeros((M, rs.L), jnp.complex64)
        return st

    def _local(state, iq):
        # iq replicated: (n, 2) f32
        x = lax.complex(iq[:, 0], iq[:, 1])
        T = x.shape[0] // M
        xp = jnp.concatenate([state["tail"], x])
        tail = xp[xp.shape[0] - (L * M - 1):]
        d = lax.axis_index("chan")
        base = d * Mloc
        # owned arm signals u_m[k] = x[kM - m]: one reshape+transpose+flip
        # relayout instead of M strided slices
        from ..ops.pfb import _arm_rows
        U_all = _arm_rows(xp, M, L - 1 + T)                 # (M, L-1+T)
        U = lax.dynamic_slice_in_dim(U_all, base, Mloc, axis=0)
        A = lax.dynamic_slice_in_dim(jnp.asarray(arms_np), base, Mloc, axis=0)
        V = fir_apply_batched(U, A, 1)                      # (Mloc, T)
        # partial DFT: contributions of OUR arms to EVERY channel
        E_cols = lax.dynamic_slice_in_dim(jnp.asarray(E_full), base, Mloc,
                                          axis=1)           # (M, Mloc)
        Wpart = E_cols @ V                                   # (M, T) complex
        # sum partials across chips, scatter channel blocks: chip d keeps
        # channels [d*Mloc, (d+1)*Mloc) — the single bulk collective
        Wr = lax.psum_scatter(Wpart.real, "chan", scatter_dimension=0,
                              tiled=True)
        Wi = lax.psum_scatter(Wpart.imag, "chan", scatter_dimension=0,
                              tiled=True)
        Y = lax.complex(Wr, Wi)                              # (Mloc, T)
        new_state = {"tail": tail}
        if rs is None:
            return new_state, jnp.stack([Y.real, Y.imag], axis=-1)
        rs_tail = state["rs"]                                # (Mloc, L) local
        xp2 = jnp.concatenate([rs_tail, Y], axis=1)
        new_state["rs"] = xp2[:, xp2.shape[1] - rs.L:]
        out = rs.resample_batched(xp2).astype(jnp.complex64)  # (Mloc, T*P/Q)
        return new_state, jnp.stack([out.real, out.imag], axis=-1)

    repl = P()
    state_specs = {"tail": repl}
    if rs is not None:
        state_specs["rs"] = P("chan", None)
    sharded = shard_map(
        _local, mesh=mesh,
        in_specs=(state_specs, P()),
        out_specs=(state_specs, P("chan", None, None)),
        check_vma=False,
    )
    step = jax.jit(sharded, donate_argnums=(0,))
    specs = {
        "in_multiple": in_mult,
        "nchans": M,
        "mesh": mesh,
        "in_sharding": NamedSharding(mesh, P()),
        "out_sharding": NamedSharding(mesh, P("chan", None, None)),
        # comm accounting: psum_scatter moves (D-1)/D of an (M, T) complex
        # plane per step (2 x f32 planes)
        "comm_bytes_per_step": lambda n: 2 * 4 * n * (D - 1) / max(D, 1),
    }
    return init_state, step, specs
