"""TopBlock — the host streaming loop (the entire residual 'scheduler').

Reference parity: gr::top_block start/run/wait lifecycle
(gnuradio-runtime/lib/top_block_impl.cc:95-155, python top_block.py:95-115).
All the reference's runtime machinery (thread-per-block, condition-variable
wakeups, forecast negotiation) collapses here to:

    while not done:
        chunks = {src: next chunk from each host-fed source}
        state, taps = jitted_step(state, chunks)     # one XLA invocation
        for sink: sink.collect(taps[sink])

Generated sources (sig_source, noise) run on-device inside the step; the loop
terminates when host-fed sources are exhausted or a `head`-style item limit is
reached, after which sink collections are trimmed to the exact expected item
counts using the same rational rate algebra the compiler used (so results are
chunk-size invariant, matching the reference's history discipline —
SURVEY.md App. C "history/alignment invariance").
"""
from __future__ import annotations

import math
from fractions import Fraction

import jax
import numpy as np

from .block import SinkBlock, SourceBlock
from .stream import host_decode, host_encode
from .compile import CompiledGraph
from .graph import Flowgraph
from .tags import Tag, TagStream, propagate, TPP_DONT


class _TagEngine:
    """Host sideband: advances per-edge tag streams one step at a time with
    the exact rational rate algebra the compiler solved (the block_executor
    propagate_tags analog, block_executor.cc:86-214 — including its per-port
    semantics: each input PORT has its own read counter and window, each
    output port its own write counter; ONE_TO_ONE maps input port p to
    output port p only, ALL_TO_ALL fans every input tag to every output,
    offsets scaled by the exact out_rate[q]/in_rate[p] Fraction)."""

    def __init__(self, cg: CompiledGraph):
        self.cg = cg
        for b in cg.all_blocks():
            b.reset_host_state()  # offsets restart at 0 with this engine
        self.streams = {id(e): TagStream() for e in cg.fg.edges}
        # per-PORT absolute item counters (nitems_read/written analogs,
        # block.h:352-357 — the reference keys them by port too)
        self.read = {b: [0] * b.nin for b in cg.order}
        self.written = {b: [0] * b.nout for b in cg.order}
        self.window_tags = {}  # block -> pooled tags_in of the current window

    def _policy_propagate(self, b, tags_by_port):
        """Default per-port propagation (no transform override)."""
        out = [[] for _ in range(b.nout)]
        if b.tag_policy == TPP_DONT or not b.nin:
            return out
        if b.tag_policy == "one_to_one":
            # input port p -> output port p (block_executor.cc TPP_ONE_TO_ONE;
            # the reference errors when nin < nout — extra outputs here
            # simply receive no tags, extra inputs are dropped)
            for q in range(min(b.nin, b.nout)):
                rr = b.out_rates[q] / b.in_rates[q]
                out[q] = propagate(tags_by_port[q], b.tag_policy, rr)
            return out
        # ALL_TO_ALL: every input tag to every output port, scaled per pair
        for q in range(b.nout):
            acc = []
            for p in range(b.nin):
                rr = b.out_rates[q] / b.in_rates[p]
                acc.extend(propagate(tags_by_port[p], b.tag_policy, rr))
            out[q] = sorted(acc)
        return out

    def step(self):
        cg = self.cg
        for b in cg.order:
            nin, nout = cg.n_in[b], cg.n_out[b]
            r, w = self.read[b], self.written[b]
            tags_by_port = [[] for _ in range(b.nin)]
            for e in cg.fg.in_edges(b):
                p = e.dst.port
                s = self.streams[id(e)]
                tags_by_port[p].extend(s.get_range(r[p], r[p] + nin[p]))
                s.prune(r[p] + nin[p])
            for ts in tags_by_port:
                ts.sort()
            all_in = sorted(t for ts in tags_by_port for t in ts)
            self.window_tags[b] = all_in
            if isinstance(b, SinkBlock):
                b.collect_tags(all_in)
            elif b.nout:
                if isinstance(b, SourceBlock):
                    src_tags = getattr(b, "stream_tags", None) or []
                    out_by_port = [[t for t in src_tags
                                    if w[0] <= t.offset < w[0] + nout[0]]]
                elif getattr(b, "transform_tags_multi", None) is not None:
                    in_wins = [(r[p], r[p] + nin[p]) for p in range(b.nin)]
                    out_wins = [(w[q], w[q] + nout[q]) for q in range(b.nout)]
                    out_by_port = b.transform_tags_multi(
                        tags_by_port, in_wins, out_wins)
                elif b.transform_tags is not None:
                    # legacy single-window hook (single-in/single-out blocks)
                    out = b.transform_tags(
                        all_in,
                        (r[0], r[0] + nin[0]) if b.nin else (0, 0),
                        (w[0], w[0] + nout[0]))
                    out_by_port = [list(out) for _ in range(b.nout)]
                else:
                    out_by_port = self._policy_propagate(b, tags_by_port)
                for e in cg.fg.out_edges(b):
                    self.streams[id(e)].extend(out_by_port[e.src.port])
            for p in range(b.nin):
                r[p] += nin[p]
            for q in range(b.nout):
                w[q] += nout[q]


def _dispatch_messages(cg: CompiledGraph, max_rounds: int = 100):
    """Drain every block's outbox along msg edges until quiescent (bounded,
    the max_messages=100 analog of tpb_thread_body.cc:49)."""
    for _ in range(max_rounds):
        progressed = False
        for b in cg.all_blocks():
            for port, msg in b.drain_outbox():
                for (sb, sp, db, dp) in cg.fg.msg_edges:
                    if sb is b and sp == port:
                        db.deliver(dp, msg)
                        progressed = True
        if not progressed:
            return


class TopBlock:
    def __init__(self, fg: Flowgraph | None = None, chunk_mult: int | None = None,
                 jit: bool = True, target_items: int = 16384):
        self.fg = fg if fg is not None else Flowgraph()
        self.chunk_mult = chunk_mult
        self.target_items = target_items
        self._jit = jit
        self._compiled: CompiledGraph | None = None
        self.state = None
        from ..utils.perf import PerfCounters
        self.perf = PerfCounters()

    # gr-style sugar
    def connect(self, *points):
        self.fg.connect(*points)

    def compile(self) -> CompiledGraph:
        if self._compiled is None:
            self._compiled = CompiledGraph(self.fg, self.chunk_mult,
                                           jit=self._jit,
                                           target_items=self.target_items)
        return self._compiled

    def _expected_items(self, cg: CompiledGraph, sink: SinkBlock,
                        anchor, n_anchor_items: int) -> int:
        """Exact rational scaling of item counts along the graph, the analog
        of relative_rate bookkeeping (block.h:276-297) done with Fractions."""
        a_rate = anchor.in_rates[0] if anchor.nin else anchor.out_rates[0]
        t_anchor = cg.rates[anchor] * a_rate
        t_sink = cg.rates[sink] * sink.in_rates[0]
        return math.floor(Fraction(n_anchor_items) * t_sink / t_anchor)

    def run(self, n_steps: int | None = None):
        """Run the graph. Terminates when (a) n_steps reached, (b) any
        host-fed source is exhausted, or (c) every item-limited source
        (head-style `limit` attribute) has produced its quota."""
        cg = self.compile()
        if self.state is None:
            self.state = cg.init_state()
        state = self.state

        # --- fast-path analysis (round-3 composed-path perf): the tag and
        # message planes are host-side python run per step; when the graph
        # STATICALLY cannot use them, skip them so consecutive device steps
        # enqueue back-to-back. Tags can only ever appear if some source
        # carries stream_tags or some block has a transform hook (a block
        # that mints tags from data does so via transform_tags*); the
        # default policies only move existing tags. Likewise the msg plane
        # is dead without msg edges / msg-only blocks / msg_work overrides.
        from .block import Block as _BlockBase
        need_tags = (bool(cg.param_fed)
                     or any(getattr(b, "stream_tags", None)
                            or getattr(b, "mints_tags", False)
                            for b in cg.order)
                     or any(getattr(b, "transform_tags", None) is not None
                            or getattr(b, "transform_tags_multi", None)
                            is not None for b in cg.order))
        need_msgs = (bool(cg.fg.msg_edges) or bool(cg.msg_only)
                     or any(type(b).msg_work is not _BlockBase.msg_work
                            for b in cg.all_blocks()))
        # Deferred sink fetch: keep per-step taps as device values and
        # convert in batches — np.asarray per step would make the host wait
        # for every step before dispatching the next. Disabled when the msg
        # plane is live (msg_work may read probes mid-run).
        defer_fetch = not need_msgs

        fed_iters = {}
        for b in cg.fed_sources:
            fed_iters[b.name] = b.chunks(cg.n_out[b][0])  # iterator of chunks

        # head-style item limiters: any block exposing a `limit` attribute
        limited = [b for b in cg.order if getattr(b, "limit", None)]
        steps_limit = n_steps
        if limited:
            def _per_step(b):
                return cg.n_in[b][0] if b.nin else cg.n_out[b][0]
            # number of steps to cover every limited block's quota
            need = max(math.ceil(b.limit / _per_step(b)) for b in limited)
            steps_limit = need if steps_limit is None else min(steps_limit, need)

        tag_engine = _TagEngine(cg) if need_tags else None
        step_i = 0
        anchor_seen = {b: 0 for b in limited}
        pending = []                      # deferred device taps per step
        flush_every = 64                  # bound device-resident backlog

        def _collect(sink, host_val):
            v = host_decode(host_val, sink.tap_port)
            if getattr(sink, "_tap_scalar", False):
                v = v[0]        # undo the compiler's 0-d -> (1,) promotion
            sink.collect(v)

        def _flush():
            # ONE batched transfer for the whole backlog instead of one
            # device-to-host round trip per step and sink.
            for host in jax.device_get(pending):
                for sink in cg.sinks:
                    _collect(sink, host[sink.name])
            pending.clear()

        if not cg.order:
            # no streaming chain at all (msg-only or variables-only .grc):
            # pump the message plane alone for a bounded number of ticks —
            # the analog of a flowgraph whose only work is message handlers
            # (top_block with zero stream connections runs trivially).
            if need_msgs:
                for step_i in range(n_steps if n_steps is not None else 1):
                    for b in cg.all_blocks():
                        b.msg_work(step_i)
                    _dispatch_messages(cg)
            return self

        while steps_limit is None or step_i < steps_limit:
            fed = {}
            exhausted = False
            for b in cg.fed_sources:
                chunk = next(fed_iters[b.name], None)
                if chunk is None:
                    exhausted = True
                    break
                fed[b.name] = chunk
            if exhausted:
                break
            if steps_limit is None and not cg.fed_sources:
                raise RuntimeError(
                    "graph has no host-fed or item-limited source and no "
                    "n_steps bound — it would run forever")
            anchor_b = cg.order[0]
            n_anchor_step = (cg.n_out[anchor_b][0] if anchor_b.nout
                             else cg.n_in[anchor_b][0])
            # advance the host metadata plane FIRST: the tag sideband is
            # host-deterministic, so the window's tags are known before the
            # device step — required for tag-driven param-fed blocks
            if need_tags:
                tag_engine.step()
                for b in cg.param_fed:
                    p = np.asarray(
                        b.param_chunk(tag_engine.window_tags.get(b, []),
                                      cg.n_in[b][0]))
                    fed[b.name] = host_encode(p)
            with self.perf.measure(items=n_anchor_step):
                state, taps = cg.step(state, fed)
                if not defer_fetch:
                    taps = jax.device_get(taps)  # one batched transfer
            if defer_fetch:
                pending.append(taps)
                if len(pending) >= flush_every:
                    _flush()
            else:
                for sink in cg.sinks:
                    _collect(sink, taps[sink.name])
            if need_msgs:
                for b in cg.all_blocks():
                    b.msg_work(step_i)
                _dispatch_messages(cg)
            for b in anchor_seen:
                anchor_seen[b] += cg.n_in[b][0] if b.nin else cg.n_out[b][0]
            step_i += 1

        if pending:
            _flush()
            if need_msgs:           # deferred collects may have posted msgs
                _dispatch_messages(cg)
        self.state = state
        jax.block_until_ready(jax.tree_util.tree_leaves(state) or [0])

        # Trim sink collections to exact expected counts (head semantics).
        anchor = None
        n_anchor = None
        if limited:
            anchor = limited[0]
            n_anchor = min(anchor.limit, anchor_seen[anchor])
        elif cg.fed_sources:
            anchor = cg.fed_sources[0]
            n_anchor = getattr(anchor, "items_supplied", None)
        if anchor is not None and n_anchor is not None:
            for sink in cg.sinks:
                want = self._expected_items(cg, sink, anchor, n_anchor)
                sink.trim(want)
        return self

    def run_steps(self, n: int):
        return self.run(n_steps=n)

    # ---- live reconfiguration (top_block_impl.cc:165-206 lock/unlock +
    # flat_flowgraph.cc merge_connections) ----
    def lock(self):
        """Pause-for-edit: after lock() the flowgraph (self.fg) may be
        mutated (connect/disconnect/remove_block/swap blocks). The reference
        stops its scheduler here; our 'scheduler' is a compiled artifact, so
        lock just opens the edit window."""
        self._locked = True

    def unlock(self):
        """Recompile the edited graph and CARRY FORWARD state for surviving
        blocks by NAME (merge_connections analog: the reference reuses the
        old buffers of unchanged connections; here the per-block state
        pytrees are the buffers' moral equivalent). Blocks whose state
        structure changed (e.g. new tap length) restart from fresh init —
        exactly like the reference reallocating an incompatible buffer."""
        if not getattr(self, "_locked", False):
            raise RuntimeError("unlock() without lock()")
        self._locked = False
        old_state = self.state
        self._compiled = None
        cg = self.compile()          # re-flatten + validate + retrace
        if old_state is None:
            return self
        fresh = cg.init_state()
        merged = {}
        for name, init_leaf in fresh.items():
            old = old_state.get(name) if isinstance(old_state, dict) else None
            merged[name] = old if _state_compatible(old, init_leaf) else init_leaf
        self.state = merged
        return self

    # ---- checkpoint/resume (beyond the reference, which has none —
    # SURVEY.md §5; closest analog is file_meta_sink persistence) ----
    def save_state(self, path: str):
        """Persist the carried stream state (filter tails, loop phases, NCO
        accumulators) to an .npz; complex leaves stored as re/im planes so
        reload never needs complex host<->device transfers."""
        if self.state is None:
            raise RuntimeError("no state yet — run at least one step")
        leaves, treedef = jax.tree_util.tree_flatten(self.state)
        arrays = {}
        for i, leaf in enumerate(leaves):
            a = np.asarray(leaf)
            if np.iscomplexobj(a):
                arrays[f"leaf{i}_re"] = a.real.astype(np.float32)
                arrays[f"leaf{i}_im"] = a.imag.astype(np.float32)
            else:
                arrays[f"leaf{i}"] = a
        import pickle
        np.savez(path, __treedef__=np.frombuffer(
            pickle.dumps(treedef), np.uint8), **arrays)
        return path

    def load_state(self, path: str):
        """Restore state saved by save_state. State is keyed by BLOCK NAME:
        give blocks stable names when checkpointing across processes."""
        import pickle
        with np.load(path, allow_pickle=False) as z:
            treedef = pickle.loads(z["__treedef__"].tobytes())
            leaves = []
            i = 0
            while True:
                if f"leaf{i}" in z:
                    leaves.append(jnp_asarray_safe(z[f"leaf{i}"]))
                elif f"leaf{i}_re" in z:
                    leaves.append(complex_from_planes(z[f"leaf{i}_re"],
                                                      z[f"leaf{i}_im"]))
                else:
                    break
                i += 1
        self.state = jax.tree_util.tree_unflatten(treedef, leaves)
        return self


def _state_compatible(old, new) -> bool:
    """Same pytree structure + leaf shapes/dtypes (mergeable across a
    reconfiguration)."""
    if old is None or new is None:
        return old is None and new is None
    to = jax.tree_util.tree_structure(old)
    tn = jax.tree_util.tree_structure(new)
    if to != tn:
        return False
    lo = jax.tree_util.tree_leaves(old)
    ln = jax.tree_util.tree_leaves(new)
    return all(getattr(a, "shape", None) == getattr(b, "shape", None)
               and getattr(a, "dtype", None) == getattr(b, "dtype", None)
               for a, b in zip(lo, ln))


def jnp_asarray_safe(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def complex_from_planes(re, im):
    """Rebuild a complex device array from f32 planes inside jit (complex
    host->device transfers are unsupported on some backends)."""
    import jax.numpy as jnp
    return jax.jit(lambda r, i: jax.lax.complex(r, i))(
        jnp.asarray(re), jnp.asarray(im))
