"""Two-process DCN dryrun — the transport seam INSIDE a sharded pipeline
(VERDICT r03 item #7; reference seam: gr-zeromq/lib/base_impl.cc:38-80 +
tag_headers.cc:16-50 distributed flowgraphs).

Process A (this process): 4-device virtual CPU mesh; sharded front end
(freq-xlating FIR + rotator + quadrature demod as ONE shard_map step with
ppermute halos) -> TcpStreamSink (tags included).
Process B (spawned): TcpStreamSource -> sharded back end (audio FIR +
cross-shard-closed deemph IIR) on its own 4-device mesh -> results file.

Both processes carry state across N_STEPS chunks; the parent then runs the
same chain single-process (models/wfm.make_wfm_step) and asserts the
distributed audio matches within f32 tolerance, and that tag offsets
survived the hop. Writes the result as JSON to --out.

Run: python benchmarks/dcn_dryrun.py --out R.json   (parent / process A)
     python benchmarks/dcn_dryrun.py --role recv --port P --out F  (child)
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gnuradio_tpu.core.tags import Tag
from gnuradio_tpu.models.wfm import channel_taps, wfm_taps
from gnuradio_tpu.models.wfm_sharded import _deemph_coeffs
from gnuradio_tpu.kernels.fir_xla import fir_apply
from gnuradio_tpu.ops.iir_core import linear_recurrence
from gnuradio_tpu.parallel import transport
from gnuradio_tpu.parallel.halo import (first_order_boundary, left_halo)

FS, QR, AR = 1e6, 250e3, 50e3
CHAN_DECIM, AUDIO_DECIM = 4, 5
N_STEPS = 4
CHUNK = 80_000          # input samples per step (multiple of 20*4 shards)


def _mesh():
    return Mesh(np.array(jax.devices()[:4]), ("time",))


def make_front(mesh):
    ctaps = channel_taps(FS, QR).astype(np.complex64)
    gain = np.float32(QR / (2 * math.pi * 75e3))

    def init():
        return {"chan_tail": jnp.zeros(len(ctaps) - 1, jnp.complex64),
                "demod_prev": jnp.zeros(1, jnp.complex64)}

    def local(state, iq):
        x = lax.complex(iq[:, 0], iq[:, 1])
        xp, chan_tail = left_halo(x, state["chan_tail"], "time")
        y = fir_apply(xp, jnp.asarray(ctaps), CHAN_DECIM)
        yp, demod_prev = left_halo(y, state["demod_prev"], "time")
        p = yp[1:] * jnp.conj(yp[:-1])
        d = gain * jnp.arctan2(p.imag, p.real)
        return {"chan_tail": chan_tail, "demod_prev": demod_prev}, d

    repl = {"chan_tail": P(), "demod_prev": P()}
    fn = shard_map(local, mesh=mesh, in_specs=(repl, P("time", None)),
                   out_specs=(repl, P("time")), check_vma=False)
    return init, jax.jit(fn)


def make_back(mesh):
    ataps = wfm_taps(QR, AR).astype(np.float32)
    b0, b1, r = _deemph_coeffs(AR, 75e-6)

    def init():
        return {"audio_tail": jnp.zeros(len(ataps) - 1, jnp.float32),
                "deemph_x": jnp.zeros(1, jnp.float32),
                "deemph_y": jnp.zeros((), jnp.float32)}

    def local(state, d):
        dp, audio_tail = left_halo(d, state["audio_tail"], "time")
        a = fir_apply(dp, jnp.asarray(ataps), AUDIO_DECIM)
        ap, deemph_x = left_halo(a, state["deemph_x"], "time")
        drive = b0 * ap[1:] + b1 * ap[:-1]
        y0 = linear_recurrence(jnp.float32(r), drive, jnp.float32(0))
        audio, deemph_y = first_order_boundary(y0, jnp.float32(r),
                                               state["deemph_y"], "time")
        return {"audio_tail": audio_tail, "deemph_x": deemph_x,
                "deemph_y": deemph_y}, audio

    repl = {"audio_tail": P(), "deemph_x": P(), "deemph_y": P()}
    fn = shard_map(local, mesh=mesh, in_specs=(repl, P("time",)),
                   out_specs=(repl, P("time")), check_vma=False)
    return init, jax.jit(fn)


def run_recv(port: int, out_path: str):
    mesh = _mesh()
    init, step = make_back(mesh)
    client = transport.StreamClient("127.0.0.1", port)
    state = init()
    audio_parts = []
    tags_seen = []
    with mesh:
        while True:
            got = client.recv_items(np.complex64)
            if got is None:
                break
            items, offset, tags = got
            tags_seen.extend((t.offset, t.key) for t in tags)
            d = jnp.asarray(np.real(items).astype(np.float32))
            state, audio = step(state, d)
            audio_parts.append(np.asarray(audio))
    out = np.concatenate(audio_parts) if audio_parts else np.zeros(0)
    np.save(out_path + ".npy", out)
    with open(out_path, "w") as f:
        json.dump({"n_audio": int(out.size),
                   "n_chunks": len(audio_parts),
                   "tags": tags_seen}, f)


def run_send(out_path: str):
    mesh = _mesh()
    init, step = make_front(mesh)
    rng = np.random.default_rng(0)
    n_total = CHUNK * N_STEPS
    msg = np.convolve(rng.standard_normal(n_total + 64),
                      np.ones(64) / 64, "valid")[:n_total]
    msg /= np.abs(msg).max() + 1e-9
    phase = np.cumsum(2 * np.pi * 75e3 * msg / FS)
    iq = np.exp(1j * phase).astype(np.complex64)
    planes = np.stack([iq.real, iq.imag], -1).astype(np.float32)

    server = transport.StreamServer()
    out_json = out_path + ".recv.json"
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--role", "recv",
         "--port", str(server.port), "--out", out_json],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)

    state = init()
    sent_tags = []
    t0 = time.perf_counter()
    bytes_per_step = None
    with mesh:
        for i in range(N_STEPS):
            chunk = jnp.asarray(planes[i * CHUNK:(i + 1) * CHUNK])
            state, d = step(state, chunk)
            d_np = np.asarray(d).astype(np.complex64)  # transport is c64
            off = i * d_np.size
            tags = [Tag(off, f"chunk{i}", i)]
            sent_tags.extend((t.offset, t.key) for t in tags)
            server.send_items(d_np, off, tags)
            bytes_per_step = d_np.nbytes
    wall = time.perf_counter() - t0
    server.close()
    child.wait(timeout=120)

    with open(out_json) as f:
        res = json.load(f)
    audio = np.load(out_json + ".npy")

    # single-process golden: the unsharded functional chain
    from gnuradio_tpu.models.wfm import make_wfm_step
    init1, step1, _ = make_wfm_step(FS, QR, AR)
    s = init1()
    golden = []
    for i in range(N_STEPS):
        s, a = jax.jit(step1)(s, jnp.asarray(iq[i * CHUNK:(i + 1) * CHUNK]))
        golden.append(np.asarray(a))
    golden = np.concatenate(golden)

    m = min(len(audio), len(golden))
    err = float(np.max(np.abs(audio[:m] - golden[:m])))
    scale = float(np.max(np.abs(golden)) + 1e-12)
    ok_tags = res["tags"] == [list(t) for t in sent_tags]
    artifact = {
        "ok": bool(err / scale < 2e-4 and ok_tags and m > 0),
        "method": "two OS processes, 4-device virtual CPU mesh each; "
                  "sharded front end (freq-xlating FIR + demod, ppermute "
                  "halos) -> TCP stream hop with tag sideband -> sharded "
                  "back end (audio FIR + cross-shard deemph closure); "
                  "carried state over N steps; compared to the unsharded "
                  "single-process chain",
        "n_steps": N_STEPS,
        "input_samples_per_step": CHUNK,
        "bytes_per_step_on_wire": bytes_per_step,
        "audio_items": m,
        "max_abs_err_vs_single_process": err,
        "golden_scale": scale,
        "tags_survived": ok_tags,
        "sender_wall_s": round(wall, 3),
    }
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact))
    assert artifact["ok"], artifact
    return artifact


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default="send")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", required=True, help="result JSON path")
    args = ap.parse_args()
    if args.role == "recv":
        run_recv(args.port, args.out)
    else:
        run_send(args.out)
