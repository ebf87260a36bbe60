"""Time-sharded WBFM receiver — the multi-chip flagship path.

The same chain as models/wfm.py (reference: gr-analog/python/analog/
wfm_rcv.py:22-65 + leading freq_xlating_fir_filter channel selector), but the
step's input chunk is sharded along a "time" mesh axis: each chip demodulates
a contiguous time slice, and the scheduler-history contract (`history()`,
block.h:82-91) becomes ppermute halo exchange (parallel/halo.py). The
de-emphasis IIR — sequential per sample in the reference
(gr-analog/python/analog/fm_emph.py one-pole) — is evaluated shard-locally
with an associative scan, then closed across shards with the
first_order_boundary fixup, so the whole receive step is ONE pjit'd program
with only O(taps) traffic between devices per step.

Host boundary carries float32 (N,2) interleaved IQ (complex never crosses
host<->device — core/stream.py encoding).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..kernels.fir_xla import fir_apply
from ..ops import firdes, fxpt
from ..ops.iir_core import linear_recurrence
from .wfm import channel_taps, wfm_taps


def _deemph_coeffs(audio_rate: float, tau: float):
    """One-pole deemph in add convention: y = b0*x + b1*x[-1] + r*y[-1]
    (fm_emph.py:40-80 bilinear transform with prewarped corner)."""
    w_c = 1.0 / tau
    w_ca = 2.0 * audio_rate * math.tan(w_c / (2.0 * audio_rate))
    k = -w_ca / (2.0 * audio_rate)
    p1 = (1.0 + k) / (1.0 - k)
    b0 = -k / (1.0 - k)
    return np.float32(b0), np.float32(b0), np.float32(p1)  # b0, b1, r


def make_wfm_sharded(mesh: Mesh, samp_rate=1_000_000.0, quad_rate=250_000.0,
                     audio_rate=50_000.0, center_freq=0.0, max_dev=75_000.0,
                     tau=75e-6):
    """Returns (init_state, step, specs).

    step(state, iq_f32) -> (state, audio_f32) where iq_f32 is (N, 2) float32
    interleaved IQ sharded along "time" (N divisible by
    n_time * samp_rate/audio_rate), audio_f32 is (N/decim,) float32 sharded
    the same way. All state carries are tiny and replicated.
    """
    chan_decim = int(round(samp_rate / quad_rate))
    audio_decim = int(round(quad_rate / audio_rate))
    ctaps_base = channel_taps(samp_rate, quad_rate)
    n = np.arange(len(ctaps_base))
    w = 2 * np.pi * center_freq / samp_rate
    ctaps = (ctaps_base * np.exp(1j * w * n)).astype(np.complex64)
    ataps = wfm_taps(quad_rate, audio_rate).astype(np.float32)
    gain = np.float32(quad_rate / (2 * math.pi * max_dev))
    delta = fxpt.float_to_fxpt(-w * chan_decim)  # rotator incr per output
    b0, b1, r = _deemph_coeffs(audio_rate, tau)
    D = mesh.shape["time"]

    def init_state():
        return {
            "chan_tail": jnp.zeros((len(ctaps) - 1,), jnp.complex64),
            "phase": jnp.zeros((), jnp.int32),
            "demod_prev": jnp.zeros((1,), jnp.complex64),
            "audio_tail": jnp.zeros((len(ataps) - 1,), jnp.float32),
            "deemph_x": jnp.zeros((1,), jnp.float32),
            "deemph_y": jnp.zeros((), jnp.float32),
        }

    from ..parallel.halo import left_halo, shard_offset, first_order_boundary

    def _local_step(state, iq):
        # iq: (n_local, 2) float32 — this shard's time slice
        x = lax.complex(iq[:, 0], iq[:, 1])
        # -- channel select: freq-xlating FIR + fxpt rotator ----------------
        xp, chan_tail = left_halo(x, state["chan_tail"], "time")
        y = fir_apply(xp, jnp.asarray(ctaps), chan_decim)
        n1 = y.shape[0]
        gidx = shard_offset("time", n1) + jnp.arange(n1, dtype=jnp.int32)
        phases = state["phase"] + jnp.int32(delta) * gidx
        y = y * jnp.exp(1j * fxpt.fxpt_to_float(phases)).astype(jnp.complex64)
        phase = state["phase"] + jnp.int32(delta) * jnp.int32(n1 * D)
        # -- quadrature demod ----------------------------------------------
        yp, demod_prev = left_halo(y, state["demod_prev"], "time")
        p = yp[1:] * jnp.conj(yp[:-1])
        d = gain * jnp.arctan2(p.imag, p.real)
        # -- audio decimating FIR ------------------------------------------
        dp, audio_tail = left_halo(d, state["audio_tail"], "time")
        a = fir_apply(dp, jnp.asarray(ataps), audio_decim)
        # -- deemphasis one-pole IIR across shards -------------------------
        ap, deemph_x = left_halo(a, state["deemph_x"], "time")
        drive = b0 * ap[1:] + b1 * ap[:-1]
        y_zero = linear_recurrence(jnp.float32(r), drive, jnp.float32(0))
        audio, deemph_y = first_order_boundary(y_zero, jnp.float32(r),
                                               state["deemph_y"], "time")
        new_state = {"chan_tail": chan_tail, "phase": phase,
                     "demod_prev": demod_prev, "audio_tail": audio_tail,
                     "deemph_x": deemph_x, "deemph_y": deemph_y}
        return new_state, audio

    repl = P()
    state_specs = {"chan_tail": repl, "phase": repl, "demod_prev": repl,
                   "audio_tail": repl, "deemph_x": repl, "deemph_y": repl}
    sharded = shard_map(
        _local_step, mesh=mesh,
        in_specs=(state_specs, P("time", None)),
        out_specs=(state_specs, P("time")),
        check_vma=False,
    )

    step = jax.jit(sharded, donate_argnums=(0,))
    decim = chan_decim * audio_decim
    min_local = max(len(ctaps) - 1,
                    (len(ataps) - 1 + 1) * chan_decim,
                    decim)
    min_local = -(-min_local // decim) * decim  # round up to decim multiple
    specs = {
        "in_multiple": decim * D,
        "min_items_per_shard": min_local,
        "mesh": mesh,
        "in_sharding": NamedSharding(mesh, P("time", None)),
        "out_sharding": NamedSharding(mesh, P("time")),
        "decim": decim,
    }
    return init_state, step, specs


def make_wfm_sharded_fused(mesh: Mesh, samp_rate=1_000_000.0,
                           quad_rate=250_000.0, audio_rate=50_000.0,
                           center_freq=0.0, max_dev=75_000.0, tau=75e-6,
                           front: str = "triton", interpret: bool = False):
    """Time-sharded WBFM receiver running the PRODUCTION front end
    (kernels/wfm_front.WfmFront, the single-device flagship's front stage)
    composed with ppermute halo exchange inside shard_map. The rotator is
    algebraically eliminated (constant e^{-jwD} phasor), so no fxpt phase
    carry exists; the front's history halo (T-1+D samples per I/Q plane)
    moves between neighbouring devices, and the de-emphasis one-pole stays
    the exact cross-shard IIR closure (first_order_boundary).

    step(state, iq_f32[(N, 2)]) -> (state, audio_f32[(N/decim,)]), with N
    sharded along the "time" mesh axis. `front`/`interpret` as in
    models/wfm.make_wfm_step_fused.
    """
    from ..kernels.wfm_front import WfmFront

    chan_decim = int(round(samp_rate / quad_rate))
    audio_decim = int(round(quad_rate / audio_rate))
    front_stage = WfmFront(channel_taps(samp_rate, quad_rate), center_freq,
                           samp_rate, chan_decim,
                           quad_rate / (2 * math.pi * max_dev))
    ataps = wfm_taps(quad_rate, audio_rate).astype(np.float32)
    b0, b1, r = _deemph_coeffs(audio_rate, tau)
    D = mesh.shape["time"]
    H = front_stage.history                # T-1+D samples per plane

    def init_state():
        return {
            "front_r": jnp.zeros((H,), jnp.float32),
            "front_i": jnp.zeros((H,), jnp.float32),
            "audio_tail": jnp.zeros((len(ataps) - 1,), jnp.float32),
            "deemph_x": jnp.zeros((1,), jnp.float32),
            "deemph_y": jnp.zeros((), jnp.float32),
        }

    from ..parallel.halo import left_halo, first_order_boundary

    def _local_step(state, iq):
        # iq: (n_local, 2) f32 — split to planes once; the front reads
        # planes directly
        xr, xi = iq[:, 0], iq[:, 1]
        xrp, front_r = left_halo(xr, state["front_r"], "time")
        xip, front_i = left_halo(xi, state["front_i"], "time")
        d = front_stage(xrp, xip, impl=front, interpret=interpret)
        # -- audio decimating FIR ------------------------------------------
        dp, audio_tail = left_halo(d, state["audio_tail"], "time")
        a = fir_apply(dp, jnp.asarray(ataps), audio_decim)
        # -- deemphasis one-pole IIR across shards -------------------------
        ap, deemph_x = left_halo(a, state["deemph_x"], "time")
        drive = b0 * ap[1:] + b1 * ap[:-1]
        y_zero = linear_recurrence(jnp.float32(r), drive, jnp.float32(0))
        audio, deemph_y = first_order_boundary(y_zero, jnp.float32(r),
                                               state["deemph_y"], "time")
        new_state = {"front_r": front_r, "front_i": front_i,
                     "audio_tail": audio_tail,
                     "deemph_x": deemph_x, "deemph_y": deemph_y}
        return new_state, audio

    repl = P()
    state_specs = {"front_r": repl, "front_i": repl, "audio_tail": repl,
                   "deemph_x": repl, "deemph_y": repl}
    sharded = shard_map(
        _local_step, mesh=mesh,
        in_specs=(state_specs, P("time", None)),
        out_specs=(state_specs, P("time")),
        check_vma=False,
    )

    step = jax.jit(sharded, donate_argnums=(0,))
    decim = chan_decim * audio_decim
    min_local = max(H, (len(ataps) - 1 + 1) * chan_decim, decim)
    min_local = -(-min_local // decim) * decim
    specs = {
        "in_multiple": decim * D,
        "min_items_per_shard": min_local,
        "mesh": mesh,
        "in_sharding": NamedSharding(mesh, P("time", None)),
        "out_sharding": NamedSharding(mesh, P("time")),
        "decim": decim,
    }
    return init_state, step, specs
