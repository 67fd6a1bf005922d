"""Serving engines (counterpart of ``tdanet_tpu/serving.py``).

- ``StreamingSeparator``: push audio chunks of any size; fixed overlapped
  segments are separated one at a time, permutation-aligned against the
  first segment's tails by overlap cosine similarity (the reference's
  stitching rule) and emitted incrementally, one segment of latency;
- ``MultiStreamSeparator``: up to ``max_streams`` such streams share one
  batched forward per ``step``, every row separated as if alone;
- ``BatchSeparationServer``: offline micro-batching over
  ``utils.separator.separate_batched``;
- ``AsyncBatchServer``: request/response serving. ``submit`` returns a
  Future; a dispatch thread coalesces requests into padded batches
  (continuous batching, an adaptive batch ladder, length buckets,
  deadline shedding) and a resolver thread answers them.

The JAX engines compile one program per forward shape. Here each shape is
a :class:`Program`: on a CUDA model the forward is captured once as a CUDA
graph over static buffers on the card, and every call replays it, without
the host's cost of launching the forward's kernels one by one. An engine
keeps all its graphs in one memory pool. On a CPU model the forward runs
eagerly, because the caller asked for the CPU. On a CUDA model a forward
that cannot be captured or replayed raises (into the constructor, or into
the futures of its requests); nothing runs the eager forward in its place.

Left out of the JAX engines' arguments:

- ``dw_fold``: it picks a TPU lowering of one function,
  ``ops.dw_s2_fold``, which is not ported (ROADMAP "Not to port");
- ``params``: the model carries its weights.

``mesh`` (a local ``parallel.make_mesh``: dp replicas on a list of
devices, which may repeat) splits every batch of ``BatchSeparationServer``
and ``AsyncBatchServer`` over the replicas: each shape is one
:class:`ReplicaPrograms`, a :class:`Program` (one CUDA graph on a card) a
replica, each replica's rows on its device, collected in row order.

``serving_worker.py`` (worker recycling) and ``scripts/soak_recycle.py``
are not ported: they answer a host-memory leak of the TPU's client, which
has not shown on CUDA (ROADMAP A #2).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from tdanet_tpu_torch.utils.separator import (
    depth_kw, separate_batched, trim_renorm)

# CUDA captures one graph at a time in a process, whatever the engine; the
# lock also keeps each capture's stream to the one thread that holds it
_CAPTURE_LOCK = threading.Lock()


class DeadlineExceeded(RuntimeError):
    """Raised into a request's future when deadline-aware admission
    sheds it (AsyncBatchServer(deadline_ms=...)): the request was older
    than the deadline when its batch was assembled."""


def _resolve(fut, result=None, exc=None):
    """Resolve a Future, tolerating client-side cancellation: an
    InvalidStateError here must never kill a server thread."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:
        pass


def _cos(a, b):
    a = np.asarray(a, np.float32)  # int16 emission would overflow a raw dot
    b = np.asarray(b, np.float32)
    return float(np.dot(a, b) /
                 (np.linalg.norm(a) * np.linalg.norm(b) + 1e-8))


def _perm_align(tails: Optional[np.ndarray], est: np.ndarray,
                n_src: int, overlap_len: int) -> np.ndarray:
    """Reorder est's sources to best match the reference tails by overlap
    cosine similarity (greedy pairing for n > 2). The reference's quirks
    are kept: the tails are the FIRST segment's (frozen, see
    _StreamState.finalize), and a tied score swaps (keep needs strict >)."""
    if tails is None or overlap_len == 0:
        return est
    head = est[:, :overlap_len]
    if n_src == 2:
        keep = _cos(tails[0], head[0]) + _cos(tails[1], head[1])
        swap = _cos(tails[0], head[1]) + _cos(tails[1], head[0])
        return est if keep > swap else est[::-1]
    order, used = [], set()
    for i in range(n_src):
        best, bj = -2.0, None
        for j in range(n_src):
            if j not in used:
                c = _cos(tails[i], head[j])
                if c > best:
                    best, bj = c, j
        order.append(bj)
        used.add(bj)
    return est[order]


class _StreamState:
    """Per-stream buffering and overlap-stitch bookkeeping."""

    def __init__(self, n_src: int, seg_len: int, overlap_len: int):
        self.n_src, self.seg_len = n_src, seg_len
        self.overlap_len = overlap_len
        self.hop = seg_len - overlap_len
        self.buffer = np.zeros(0, np.float32)
        self.tails: Optional[np.ndarray] = None
        self.consumed = 0

    def feed(self, chunk: np.ndarray) -> None:
        self.buffer = np.concatenate(
            [self.buffer, np.asarray(chunk, np.float32)])

    def ready(self) -> bool:
        return self.buffer.shape[0] >= self.seg_len

    def peek_segment(self) -> np.ndarray:
        return self.buffer[:self.seg_len]

    def finalize(self, est: np.ndarray) -> np.ndarray:
        """Align a separated segment, advance the buffer, and return the
        newly finalized samples."""
        est = _perm_align(self.tails, est, self.n_src, self.overlap_len)
        if self.consumed == 0:
            # the reference's quirk, kept for parity with the offline
            # stitcher: the comparison tails are frozen at the first
            # segment's estimates, so every later segment aligns against
            # segment 0, not its predecessor
            self.tails = est[:, -self.overlap_len:] if self.overlap_len \
                else est[:, :0]
        out = est if self.consumed == 0 else est[:, self.overlap_len:]
        self.buffer = self.buffer[self.hop:]
        self.consumed += 1
        return out

    def tail_segment(self):
        """(padded_segment, n_emit, pad_len) for flush; None if nothing is
        left to emit."""
        n = self.buffer.shape[0]
        emitted_overlap = self.overlap_len if self.consumed > 0 else 0
        if n <= emitted_overlap:
            return None
        pad_len = self.seg_len - n
        seg = np.concatenate([self.buffer, np.zeros(pad_len, np.float32)])
        return seg, emitted_overlap, pad_len

    def export(self) -> dict:
        """Picklable snapshot: all a fresh engine needs to continue this
        stream with no sample dropped or repeated."""
        return {"buffer": self.buffer.copy(),
                "tails": None if self.tails is None else self.tails.copy(),
                "consumed": self.consumed}

    def restore(self, snap: dict) -> None:
        self.buffer = np.asarray(snap["buffer"], np.float32).copy()
        self.tails = None if snap["tails"] is None else \
            np.asarray(snap["tails"]).copy()
        self.consumed = int(snap["consumed"])


def _device(model):
    return next(model.parameters()).device


class _Slot:
    """Host side of one launch: pinned input and output on a CUDA model
    and the event that marks the output copied; the eager result on the
    CPU."""

    def __init__(self, x=None, out=None):
        self.x, self.out = x, out
        self.event = None if x is None else torch.cuda.Event()
        self.result = None


class Program:
    """One forward shape of an engine: (rows, length) float32 host batches
    in, the estimates of ``fn`` out as numpy.

    ``fn`` maps a (rows, length) float32 tensor on ``device`` to the
    estimates, in a dtype numpy has (not bf16). On a CUDA device it is run
    once eagerly (the kernels' builds and plans, cuBLAS and cuDNN set-up)
    and then captured as one CUDA graph into ``pool``, both on ``stream``
    (:func:`capture_stream`), under a process-wide lock, in the
    ``thread_local`` capture mode: other threads keep using the card
    meanwhile. An engine's graphs share one pool and one capture stream
    (the allocator reuses a block only on the stream it was made on, so a
    later capture then fits into what an earlier one freed), and replay
    in turn on one stream.
    :meth:`launch` queues, on the calling thread's current stream, the
    batch's copy from a pinned slot into the graph's static input, the
    replay, the copy of the static output into the slot's pinned output,
    and an event; :meth:`collect` waits on that event alone and reads
    host memory. A slot is free again once collected; up to ``slots``
    launches are in flight (slots are made as they are first needed), and
    :meth:`launch` waits for a free one.

    On the CPU, :meth:`launch` runs ``fn`` eagerly."""

    def __init__(self, fn, rows, length, device, pool=None, stream=None,
                 slots=1):
        self.rows, self.length = rows, length
        self.fn, self.device = fn, device
        self.replays = 0
        self.graph = None
        self._free: "queue.Queue[_Slot]" = queue.Queue()
        self._unmade = slots
        if device.type != "cuda":
            return
        self.graph, (self.x,), self.out = capture(
            fn, lambda: (torch.zeros((rows, length), dtype=torch.float32,
                                     device=device),),
            device, pool, stream)

    def _slot(self) -> _Slot:
        try:
            return self._free.get_nowait()
        except queue.Empty:
            pass
        if self._unmade == 0:
            return self._free.get()
        self._unmade -= 1
        if self.graph is None:
            return _Slot()
        return _Slot(torch.empty((self.rows, self.length),
                                 dtype=torch.float32, pin_memory=True),
                     torch.empty(self.out.shape, dtype=self.out.dtype,
                                 pin_memory=True))

    def launch(self, batch: np.ndarray) -> _Slot:
        """Queue one forward of ``batch``; returns the ticket for
        :meth:`collect`."""
        if batch.shape != (self.rows, self.length):
            raise ValueError(f"batch {batch.shape} for a program of "
                             f"{(self.rows, self.length)}")
        slot = self._slot()
        try:
            with torch.inference_mode():
                if self.graph is None:
                    slot.result = self.fn(torch.from_numpy(
                        np.ascontiguousarray(batch, np.float32))).numpy()
                    return slot
                slot.x.numpy()[...] = batch
                self.x.copy_(slot.x, non_blocking=True)
                self.graph.replay()
                slot.out.copy_(self.out, non_blocking=True)
                slot.event.record()
        except BaseException:
            self._free.put(slot)
            raise
        self.replays += 1
        return slot

    def collect(self, slot: _Slot) -> np.ndarray:
        """The estimates of one launch, as a numpy array of their own;
        frees the slot."""
        try:
            if self.graph is None:
                return slot.result
            slot.event.synchronize()
            return slot.out.numpy().copy()
        finally:
            slot.result = None
            self._free.put(slot)

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        return self.collect(self.launch(batch))

    @property
    def stats(self):
        """Forwards replayed from the graph, and the graphs (0 or 1)."""
        return {"replays": self.replays, "graphs": int(self.graph is not None)}


class ReplicaPrograms:
    """One forward shape over dp replicas (one without a mesh):
    ``fns[i]`` (replica i's forward) as a :class:`Program` of its rows on
    ``devices[i]``, in that device's pool and capture stream. A batch's
    rows are split in contiguous parts (``row_slices``); :meth:`launch`
    queues each part on its device's stream (``streams``, the current
    stream where None), :meth:`collect` joins the estimates in row order
    (one part's are returned as they are)."""

    def __init__(self, fns, rows, length, devices, row_slices, pools,
                 capture_streams, streams, slots=1):
        self.rows, self.length = rows, length
        self.row_slices = row_slices
        self.streams = streams
        self.parts = [Program(fn, sl.stop - sl.start, length, d,
                              pool=pools.get(d),
                              stream=capture_streams.get(d), slots=slots)
                      for fn, d, sl in zip(fns, devices, row_slices)]

    @property
    def graph(self):
        """A captured graph when the parts are graphs, else None."""
        return self.parts[0].graph

    def launch(self, batch: np.ndarray):
        if batch.shape != (self.rows, self.length):
            raise ValueError(f"batch {batch.shape} for a program of "
                             f"{(self.rows, self.length)}")
        tickets = []
        try:
            for prog, sl in zip(self.parts, self.row_slices):
                stream = self.streams.get(prog.device)
                ctx = torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext()
                with ctx:
                    tickets.append(prog.launch(batch[sl]))
        except BaseException:  # free the parts already launched
            for prog, t in zip(self.parts, tickets):
                prog.collect(t)
            raise
        return tickets

    def collect(self, tickets) -> np.ndarray:
        if len(self.parts) == 1:
            return self.parts[0].collect(tickets[0])
        return np.concatenate([prog.collect(t)
                               for prog, t in zip(self.parts, tickets)])

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        return self.collect(self.launch(batch))

    @property
    def replays(self):
        """Forwards replayed from the parts' graphs, every part's."""
        return sum(p.replays for p in self.parts)

    @property
    def stats(self):
        return {"replays": self.replays,
                "graphs": sum(p.graph is not None for p in self.parts)}


def capture(fn, make_inputs, device, pool=None, stream=None):
    """``fn`` on the static inputs that ``make_inputs()`` allocates, run
    once eagerly and then captured as one CUDA graph into ``pool``, both
    on ``stream`` (:func:`capture_stream` when None), under the
    process-wide lock, in the ``thread_local`` capture mode. Returns
    (graph, inputs, outputs): a replay reads the inputs and rewrites the
    outputs in place."""
    caller = torch.cuda.current_stream(device)
    stream = stream or capture_stream(device)
    with _CAPTURE_LOCK:
        stream.wait_stream(caller)
        with torch.inference_mode(), torch.cuda.stream(stream):
            inputs = make_inputs()
            fn(*inputs)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = fn(*inputs)
        caller.wait_stream(stream)
    return graph, inputs, out


def pool_handle(device):
    """A new graph memory pool on a CUDA device; None on the CPU."""
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None


def capture_stream(device):
    """A stream to capture on: one of the high-priority pool, which no
    engine replays on (streams are handed out round-robin from a pool, so
    a capture on a default-priority stream could record another thread's
    replays); None on the CPU."""
    return torch.cuda.Stream(device, priority=-1) \
        if device.type == "cuda" else None


def pool_bytes(pool):
    """Bytes the card's allocator holds in the graph pool ``pool``."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def _estimates(est):
    """Estimates as a program returns them: bf16 as float32 (numpy has no
    bf16), other dtypes kept."""
    return est.to(torch.promote_types(est.dtype, torch.float32))


def pcm16(est):
    """Estimates as 16-bit PCM: ``round(clamp(est, -1, 1) * 32767)`` in
    float32, half to even (as ``jnp.round``)."""
    return torch.round(torch.clamp(est.float(), -1.0, 1.0)
                       * 32767.0).to(torch.int16)


def _model_forward(model, compute_dtype, num_blocks):
    """The (B, T) -> (B, n_src, T) forward, every row as if alone (the
    counterpart of the JAX engines' vmap)."""
    depth = depth_kw(num_blocks)
    return lambda x: model(x, per_utterance=True,
                           compute_dtype=compute_dtype, **depth)


class StreamingSeparator:
    """Online chunked separation with PIT-consistent stitching.

    Latency: one segment (``segment`` seconds); each ``push`` returns the
    newly finalized samples per source (possibly none). ``flush``
    separates the zero-padded tail and returns the remainder, with the
    reference's pad and trim bookkeeping.

    One forward shape, (1, seg_len): a CUDA graph on a CUDA model, made
    here. ``compute_dtype`` (a torch dtype) goes to
    ``TDANetBest.forward(compute_dtype=)``, ``num_blocks`` is the
    early-exit depth. ``forward_fn``, if given, maps a (B, seg_len) tensor
    on the model's device to (B, n_src, seg_len) and takes the model's
    forward's place (depth and dtype are then its own); it is captured
    the same way. Estimates are not renormalised, as in the JAX engine;
    bf16 estimates come out as float32."""

    def __init__(self, model, segment=4.0, overlap=0.25, sample_rate=8000,
                 compute_dtype=None, num_blocks=None, forward_fn=None):
        self.model = model
        self.sr = sample_rate
        self.seg_len = int(segment * sample_rate)
        self.overlap_len = int(self.seg_len * overlap)
        self.hop = self.seg_len - self.overlap_len
        self.n_src = model.num_sources
        device = _device(model)
        fwd = forward_fn or _model_forward(model, compute_dtype, num_blocks)
        self._prog = Program(lambda x: _estimates(fwd(x)), 1, self.seg_len,
                             device, pool=pool_handle(device))
        self.reset()

    @property
    def stats(self):
        return self._prog.stats

    def reset(self):
        self._state = _StreamState(self.n_src, self.seg_len,
                                   self.overlap_len)

    def export_state(self) -> dict:
        """Picklable mid-stream state for a handoff to another engine: the
        buffered samples and the overlap tails determine the rest."""
        return self._state.export()

    def restore_state(self, snap: dict) -> None:
        self.reset()
        self._state.restore(snap)

    def _separate(self, seg: np.ndarray) -> np.ndarray:
        return self._prog(seg[None])[0]

    def push(self, chunk: np.ndarray) -> np.ndarray:
        """Feed samples; returns the newly finalized (n_src, n_new)."""
        self._state.feed(chunk)
        outs: List[np.ndarray] = []
        while self._state.ready():
            est = self._separate(self._state.peek_segment())
            outs.append(self._state.finalize(est))
        if outs:
            return np.concatenate(outs, axis=1)
        return np.zeros((self.n_src, 0), np.float32)

    def flush(self) -> np.ndarray:
        """Separate the remaining tail (zero-padded) and reset."""
        tail = self._state.tail_segment()
        if tail is None:
            self.reset()
            return np.zeros((self.n_src, 0), np.float32)
        seg, emitted_overlap, pad_len = tail
        est = _perm_align(self._state.tails, self._separate(seg),
                          self.n_src, self.overlap_len)
        out = est[:, emitted_overlap:self.seg_len - pad_len]
        self.reset()
        return out


class MultiStreamSeparator:
    """Concurrent online streams sharing one batched forward.

    Up to ``max_streams`` independent streams are stitched with the
    per-stream semantics of ``StreamingSeparator``, but every ``step()``
    separates all ready segments in one forward of (max_streams, seg_len)
    rows (a CUDA graph on a CUDA model, made here), each row separated as
    if alone (``per_utterance=True``).

    ``emit_dtype="int16"`` rounds on the card, inside the graph, to 16-bit
    PCM (:func:`pcm16`). ``compute_dtype``, ``num_blocks`` and
    ``forward_fn`` (here from (max_streams, seg_len) to (max_streams,
    n_src, seg_len)) are as in ``StreamingSeparator``. With ``model=None``
    (a deployment bundle's program, ``deploy.load_streaming``) the forward
    is ``forward_fn`` alone, and ``n_src`` and ``device`` say what the
    model would.

    Usage: ``open(sid)`` -> ``push(sid, chunk)`` (buffers only) ->
    ``step()`` -> {sid: newly finalized audio} -> ``flush(sid)``.
    """

    def __init__(self, model, max_streams=4, segment=4.0, overlap=0.25,
                 sample_rate=8000, compute_dtype=None, emit_dtype="float32",
                 num_blocks=None, forward_fn=None, n_src=None, device=None):
        if emit_dtype not in ("float32", "int16"):
            raise ValueError(f"emit_dtype must be float32 or int16, got "
                             f"{emit_dtype!r}")
        if model is None and (forward_fn is None or n_src is None
                              or device is None):
            raise ValueError("without a model, forward_fn, n_src and device "
                             "are needed")
        self.model = model
        self.max_streams = max_streams
        self.seg_len = int(segment * sample_rate)
        self.overlap_len = int(self.seg_len * overlap)
        self.n_src = model.num_sources if model is not None else n_src
        self.emit_dtype = emit_dtype
        fwd = forward_fn or _model_forward(model, compute_dtype, num_blocks)

        def emit(x):
            return (pcm16 if emit_dtype == "int16" else _estimates)(fwd(x))

        device = _device(model) if model is not None \
            else torch.device(device)
        self._prog = Program(emit, max_streams, self.seg_len, device,
                             pool=pool_handle(device))
        self._streams: Dict[object, _StreamState] = {}

    @property
    def stats(self):
        return self._prog.stats

    def open(self, stream_id) -> None:
        if stream_id in self._streams:
            # a silent replacement would drop buffered samples and tails
            raise ValueError(f"stream {stream_id!r} is already open; "
                             f"close() it first")
        if len(self._streams) >= self.max_streams:
            raise ValueError(f"max_streams={self.max_streams} exceeded")
        self._streams[stream_id] = _StreamState(
            self.n_src, self.seg_len, self.overlap_len)

    def export_state(self) -> dict:
        """Picklable {stream_id: snapshot} of every open stream."""
        return {sid: st.export() for sid, st in self._streams.items()}

    def restore_state(self, state: dict) -> None:
        self._streams.clear()
        for sid, snap in state.items():
            self.open(sid)
            self._streams[sid].restore(snap)

    def close(self, stream_id) -> None:
        self._streams.pop(stream_id, None)

    def push(self, stream_id, chunk: np.ndarray) -> None:
        """Buffer samples for one stream (no device work)."""
        self._streams[stream_id].feed(chunk)

    def _dispatch(self, segs: List[np.ndarray]) -> np.ndarray:
        batch = np.zeros((self.max_streams, self.seg_len), np.float32)
        batch[:len(segs)] = np.stack(segs)
        return self._prog(batch)

    def step(self) -> Dict[object, np.ndarray]:
        """Separate one ready segment of every stream that has one, in one
        batched forward. Returns {stream_id: (n_src, n_new)}. Call again
        until empty to drain multi-segment backlogs."""
        ready = [(sid, st) for sid, st in self._streams.items()
                 if st.ready()]
        out: Dict[object, np.ndarray] = {}
        for group_start in range(0, len(ready), self.max_streams):
            group = ready[group_start:group_start + self.max_streams]
            ests = self._dispatch([st.peek_segment() for _, st in group])
            for (sid, st), est in zip(group, ests):
                out[sid] = st.finalize(est)
        return out

    def flush(self, stream_id) -> np.ndarray:
        """Drain any full segments still buffered (a client may flush
        without a final step()), then separate the zero-padded tail and
        close the stream.

        The whole backlog is known from the buffer up front (segments
        advance by ``hop``; permutation alignment is host work), so a
        k-segment backlog and its tail share ``ceil((k+1)/max_streams)``
        batched forwards."""
        st = self._streams[stream_id]
        segs: List[np.ndarray] = []
        n, off = st.buffer.shape[0], 0
        while n - off >= st.seg_len:
            segs.append(st.buffer[off:off + st.seg_len])
            off += st.hop
        # the tail's bookkeeping as _StreamState.tail_segment would give it
        # after the full segments were consumed
        emitted_overlap = st.overlap_len if (st.consumed + len(segs)) \
            else 0
        tail_meta = None
        if n - off > emitted_overlap:
            pad_len = st.seg_len - (n - off)
            segs.append(np.concatenate(
                [st.buffer[off:], np.zeros(pad_len, np.float32)]))
            tail_meta = (emitted_overlap, pad_len)
        ests: List[np.ndarray] = []
        for s0 in range(0, len(segs), self.max_streams):
            chunk = segs[s0:s0 + self.max_streams]
            ests.extend(self._dispatch(chunk)[:len(chunk)])
        parts: List[np.ndarray] = []
        n_full = len(segs) - (1 if tail_meta else 0)
        for est in ests[:n_full]:
            parts.append(st.finalize(est))
        if tail_meta:
            emitted_overlap, pad_len = tail_meta
            est = _perm_align(st.tails, ests[-1], self.n_src,
                              self.overlap_len)
            parts.append(est[:, emitted_overlap:self.seg_len - pad_len])
        self.close(stream_id)
        if parts:
            return np.concatenate(parts, axis=1)
        return np.zeros((self.n_src, 0),
                        np.int16 if self.emit_dtype == "int16"
                        else np.float32)


class BatchSeparationServer:
    """Offline micro-batching over bucketed batched separation; ``mesh``
    splits every batch over a local mesh's replicas (``batch_size`` a
    multiple of dp), as ``separate_batched`` does."""

    def __init__(self, model, batch_size=8, compute_dtype=None, mesh=None):
        self.model = model
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.mesh = mesh
        if mesh is not None:
            from tdanet_tpu_torch.parallel.mesh import check_dp_batch
            check_dp_batch(mesh, batch_size)

    def separate(self, wavs):
        return separate_batched(self.model, wavs,
                                batch_size=self.batch_size,
                                compute_dtype=self.compute_dtype,
                                mesh=self.mesh)


class AsyncBatchServer:
    """Asynchronous micro-batching separation server (online request/
    response serving).

    ``submit(wav)`` returns a ``concurrent.futures.Future`` at once; a
    dispatch thread drains the request queue, coalescing up to the current
    batch size or waiting at most ``max_wait_ms`` for the batch to fill,
    buckets the requests by padded length (one program per bucket and
    batch size), and a resolver thread answers every future with the
    (n_src, T) estimate, trimmed and renormalised per utterance as the
    eval path does (``utils.separator.trim_renorm``).

    Continuous batching: the dispatch thread queues batch k on the card
    and hands it to the resolver, then coalesces batch k+1 while batch k
    runs. ``pipeline_depth`` bounds the batches in flight; when the card
    falls behind, the bounded handoff holds the dispatch thread, requests
    pile up and later batches coalesce full without waiting.

    Every row is separated as if alone (``per_utterance=True``); a batch
    is padded to its program's row count.

    Adaptive batch sizing (``adaptive=True``): the batch size walks a
    ladder ``min_batch, 2 min_batch, ..., max_batch``, one rung up under
    sustained overload (full coalesces with a standing queue), down when
    traffic thins. A bigger rung's programs are made on a background
    thread and become eligible once ready; until then dispatches run at
    the largest ready rung.

    ``length_buckets`` (samples) pad a request to the smallest bucket
    that holds it (past the largest, to the model's lattice);
    ``deadline_ms`` sheds a request older than that when its batch is
    assembled, with ``DeadlineExceeded``.

    The program cache maps (padded length, rows) to a
    :class:`ReplicaPrograms` of one part a replica (one without a mesh):
    a CUDA graph on a CUDA model (a device's graphs in one pool, replayed
    on one stream of the device), the eager forward on a CPU model.
    ``stats`` counts dispatches, rows, the largest batch, the highest
    rung, the programs' graphs and replays, and the background builds that
    failed: such a rung is never grown into (the smaller rung keeps
    serving, from its own graph), and its error stays in
    ``build_errors``, keyed by (padded length, rows).

    ``mesh`` (a local ``parallel.make_mesh``): dp scale-out. ``max_batch``
    and every rung are multiples of dp; each program has one graph a
    replica, each replica's rows on its device;
    ``stats["graphs"]`` and ``stats["replays"]`` count every replica's.
    """

    def __init__(self, model, max_batch=8, max_wait_ms=5.0,
                 compute_dtype=None, pipeline_depth=2, num_blocks=None,
                 adaptive=False, min_batch=None, length_buckets=None,
                 deadline_ms=None, mesh=None):
        self.model = model
        self.max_batch = max_batch
        self.device = _device(model)
        self.mesh = mesh
        if mesh is not None:
            from tdanet_tpu_torch.parallel import dp_batch_setup
            _, self._replicas = dp_batch_setup(mesh, max_batch, model,
                                               what="max_batch")
            self._devices = list(mesh.devices)
        else:
            self._replicas, self._devices = [model], [self.device]
        self.lattice = getattr(model, "lcm", 1)
        # the length axis of the padding ladder: coarse buckets trade
        # bounded padding for full batches and a bounded program set
        self.length_buckets = None
        if length_buckets:
            self.length_buckets = sorted(
                {-(-int(t) // self.lattice) * self.lattice
                 for t in length_buckets})
        self.deadline = deadline_ms / 1e3 if deadline_ms else None
        self.stats_shed = 0
        self.max_wait = max_wait_ms / 1e3
        self.compute_dtype = compute_dtype
        self.num_blocks = num_blocks
        self._slots = max(1, pipeline_depth) + 2
        if adaptive:
            lo = min_batch if min_batch is not None else min(8, max_batch)
            if mesh is not None and lo % mesh.dp:
                raise ValueError(
                    f"min_batch ({lo}) must be a multiple of the mesh dp "
                    f"axis ({mesh.dp}) for sharded serving")
            ladder, b = [], lo
            while b < max_batch:
                ladder.append(b)
                b *= 2
            ladder.append(max_batch)
            self._ladder = sorted(set(ladder))
        else:
            self._ladder = [max_batch]
        self._rung = 0          # index of the current target rung
        self._pressure = 0      # consecutive full coalesces with backlog
        self._idle = 0          # consecutive under-filled coalesces
        self.stats = {"dispatches": 0, "rows": 0, "max_B": 0,
                      "rung_highwater": 0, "graphs": 0, "replays": 0,
                      "build_errors": 0}
        self.build_errors: Dict[tuple, Exception] = {}
        self._targets: Dict[int, None] = {}  # active bucket lengths (LRU)
        self._fwd_cache: Dict[tuple, ReplicaPrograms] = {}  # (target, B)
        self._cache_lock = threading.Lock()
        self._compile_sched: set = set()     # (target, B) queued/building
        self._compile_q: "queue.Queue" = queue.Queue()
        self._q: "queue.Queue" = queue.Queue()
        self._inflight: "queue.Queue" = queue.Queue(
            maxsize=max(1, pipeline_depth))
        # one graph pool, capture stream and replay stream a device
        devices = dict.fromkeys(self._devices)
        self._pools = {d: pool_handle(d) for d in devices}
        self._captures = {d: capture_stream(d) for d in devices}
        self._streams = {d: torch.cuda.Stream(d) for d in devices
                         if d.type == "cuda"}
        self._alive = True
        # serializes submit's alive-check and enqueue against close's
        # alive-flip: a submit racing close could otherwise enqueue after
        # both drains ran, leaving a future that never resolves
        self._submit_lock = threading.Lock()
        self._resolver = threading.Thread(target=self._resolve_loop,
                                          daemon=True)
        self._resolver.start()
        self._compiler = None
        if len(self._ladder) > 1:
            self._compiler = threading.Thread(target=self._compile_loop,
                                              daemon=True)
            self._compiler.start()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side -------------------------------------------------------

    def submit(self, wav: np.ndarray) -> Future:
        wav = np.asarray(wav, np.float32)
        if wav.ndim != 1 or wav.size == 0:
            # reject here: a malformed row would otherwise raise during
            # batch assembly on the dispatch thread
            raise ValueError(
                f"submit() takes one mono waveform (T,), got shape "
                f"{wav.shape}")
        with self._submit_lock:
            if not self._alive:
                raise RuntimeError("AsyncBatchServer is closed")
            fut: Future = Future()
            self._q.put((wav, fut, time.monotonic()))
        return fut

    def separate(self, wav: np.ndarray, timeout=None) -> np.ndarray:
        return self.submit(wav).result(timeout=timeout)

    def prewarm(self, lengths=None, rungs=None):
        """Make the (length bucket x batch rung) program grid on the
        calling thread before taking traffic, so that no request waits on
        a capture. Defaults: the configured length_buckets x the ladder.
        The largest programs are captured first: the smaller ones then
        find room in the blocks they freed in the engine's pool."""
        lengths = lengths if lengths is not None else \
            (self.length_buckets or [])
        targets = sorted({-(-int(t) // self.lattice) * self.lattice
                          for t in lengths}, reverse=True)
        for t in targets[::-1]:
            self._note_target(t)
        for B in sorted(rungs if rungs is not None else self._ladder,
                        reverse=True):
            for t in targets:
                self._get_fwd(t, B)

    def pool_bytes(self):
        """Bytes of the cards' memory the engine's graphs hold."""
        return sum(pool_bytes(p) for p in self._pools.values()
                   if p is not None)

    def close(self):
        with self._submit_lock:
            self._alive = False
            self._q.put(None)
        self._worker.join(timeout=10)
        self._resolver.join(timeout=10)
        if self._compiler is not None:
            self._compile_q.put(None)
            self._compiler.join(timeout=10)
        self._drain_queue(RuntimeError("AsyncBatchServer closed"))
        for stream in self._streams.values():
            stream.synchronize()

    def _drain_queue(self, exc):
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                _resolve(item[1], exc=exc)

    # -- programs ----------------------------------------------------------

    def _build_fwd(self, target: int, B: int) -> ReplicaPrograms:
        if self.mesh is None:
            rows = [slice(0, B)]
        else:
            from tdanet_tpu_torch.parallel import batch_sharding
            rows = batch_sharding(self.mesh, B)
        fwds = [_model_forward(m, self.compute_dtype, self.num_blocks)
                for m in self._replicas]
        prog = ReplicaPrograms(
            [lambda x, f=f: _estimates(f(x)) for f in fwds], B, target,
            self._devices, rows, self._pools, self._captures, self._streams,
            slots=self._slots)
        with self._cache_lock:
            self.stats["graphs"] += prog.stats["graphs"]
        return prog

    def _get_fwd(self, target: int, B: int) -> ReplicaPrograms:
        """Blocking build: rung 0, prewarm, and the non-adaptive path."""
        key = (target, B)
        with self._cache_lock:
            fn = self._fwd_cache.get(key)
        if fn is None:
            fn = self._build_fwd(target, B)
            with self._cache_lock:
                self._fwd_cache[key] = fn
        return fn

    def _ready_fwd(self, target: int, B: int):
        with self._cache_lock:
            return self._fwd_cache.get((target, B))

    def _schedule_compile(self, target: int, B: int) -> None:
        with self._cache_lock:
            key = (target, B)
            if key in self._fwd_cache or key in self._compile_sched \
                    or key in self.build_errors:
                return
            self._compile_sched.add(key)
        self._compile_q.put(key)

    def _compile_loop(self):
        """Background capture thread: bigger rungs become eligible without
        blocking the dispatch thread (captures use their own stream)."""
        while True:
            key = self._compile_q.get()
            if key is None:
                return
            try:
                fn = self._build_fwd(*key)
                with self._cache_lock:
                    self._fwd_cache[key] = fn
            except Exception as e:
                # an unbuildable rung is never grown into (nor built again);
                # the live rung keeps serving
                with self._cache_lock:
                    self.build_errors[key] = e
                    self.stats["build_errors"] += 1
            finally:
                with self._cache_lock:
                    self._compile_sched.discard(key)

    # -- dispatch thread ---------------------------------------------------

    def _coalesce(self, first):
        """Fill up to the current rung's batch size, waiting at most
        ``max_wait`` on an idle card; while the in-flight handoff is full,
        waiting costs nothing (a slot must open before this batch could
        run), so keep coalescing past the deadline."""
        cap = self._ladder[self._rung]
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while self._alive and len(batch) < cap:
            now = time.monotonic()
            past = now >= deadline
            if past and not self._inflight.full():
                break
            # past the deadline the break condition is a slot opening, so
            # poll finely: a coarse poll adds its period to the latency
            timeout = 0.005 if past else max(deadline - now, 0.002)
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                if not self._inflight.full():
                    break
                continue
            if nxt is None:
                self._alive = False
                break
            batch.append(nxt)
        return batch

    def _run(self):
        # the first device's replay stream: a capture on this thread
        # orders itself after it
        stream = self._streams.get(self._devices[0])
        ctx = torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()
        with torch.inference_mode(), ctx:
            while self._alive:
                try:
                    item = self._q.get(timeout=0.2)
                except queue.Empty:
                    continue
                if item is None:
                    break
                batch = self._coalesce(item)
                self._adapt(len(batch))
                self._dispatch(batch)
        # the resolver finishes what is in flight, then exits
        self._inflight.put(None)
        # nothing queued behind the sentinel may hang
        self._drain_queue(RuntimeError("AsyncBatchServer worker exited"))

    def _note_target(self, target: int) -> None:
        """Track hot bucket lengths (a small LRU) so a rung grow can make
        the bigger program for every length in play."""
        self._targets.pop(target, None)
        self._targets[target] = None
        while len(self._targets) > 16:
            self._targets.pop(next(iter(self._targets)))

    def _adapt(self, n: int) -> None:
        """Walk the batch-size ladder: sustained full coalesces with a
        standing queue grow the rung (its programs made in the
        background); sustained coalesces that fit the lower rung shrink
        it, so a lone request never pays big-batch padded latency."""
        if len(self._ladder) == 1:
            return
        cap = self._ladder[self._rung]
        if n >= cap and not self._q.empty():
            self._pressure += 1
            self._idle = 0
            if self._pressure >= 2 and self._rung < len(self._ladder) - 1:
                self._rung += 1
                self._pressure = 0
                self.stats["rung_highwater"] = max(
                    self.stats["rung_highwater"], self._rung)
                for t in list(self._targets):
                    self._schedule_compile(t, self._ladder[self._rung])
        elif self._rung > 0 and n <= self._ladder[self._rung - 1]:
            # only coalesces that would have fit the lower rung count as
            # idle: shrinking on any under-filled one oscillates at the
            # rung boundary
            self._idle += 1
            self._pressure = 0
            if self._idle >= 4:
                self._rung -= 1
                self._idle = 0
        else:
            self._pressure = 0
            self._idle = 0

    def _pick_fwd(self, target: int, n: int = None):
        """(B, program, err): the largest ready rung <= the current target
        rung; schedules a background build of the target rung when it is
        not ready. Rung 0 builds synchronously: it is the baseline that is
        always there (and the only rung when adaptive=False).

        When ``n`` (the group's size) is given, the scan starts at the
        smallest rung that fits n: a half-filled coalesce through the big
        program spends its padding rows' compute for nothing."""
        top = self._rung
        if n is not None:
            while top > 0 and self._ladder[top - 1] >= n:
                top -= 1
        for i in range(top, 0, -1):
            B = self._ladder[i]
            fn = self._ready_fwd(target, B)
            if fn is not None:
                return B, fn, None
            if i == top:
                self._schedule_compile(target, B)
        try:
            return self._ladder[0], self._get_fwd(target, self._ladder[0]), \
                None
        except Exception as e:  # a failed build fails the bucket
            return 0, None, e

    def _target(self, length: int) -> int:
        t = -(-length // self.lattice) * self.lattice
        for b in self.length_buckets or ():
            if b >= t:
                return b
        return t

    def _dispatch(self, batch):
        """Bucket and queue the forwards without waiting for them; the
        resolver thread waits. Build and launch errors resolve the
        affected futures here and never kill the thread."""
        if self.deadline is not None:
            now = time.monotonic()
            kept = []
            for wav, fut, ts in batch:
                if now - ts > self.deadline:
                    self.stats_shed += 1
                    _resolve(fut, exc=DeadlineExceeded(
                        f"request waited {(now - ts) * 1e3:.0f} ms > "
                        f"deadline {self.deadline * 1e3:.0f} ms"))
                else:
                    kept.append((wav, fut, ts))
            batch = kept
        buckets: Dict[int, list] = {}
        for wav, fut, _ts in batch:
            buckets.setdefault(self._target(wav.shape[-1]), []).append(
                (wav, fut))
        for target, reqs in buckets.items():
            self._note_target(target)
            B, fwd, err = self._pick_fwd(target, n=len(reqs))
            if fwd is None:
                for _, fut in reqs:
                    _resolve(fut, exc=err)
                continue
            for s in range(0, len(reqs), B):
                group = reqs[s:s + B]
                self.stats["dispatches"] += 1
                self.stats["rows"] += len(group)
                self.stats["max_B"] = max(self.stats["max_B"], B)
                try:
                    # assembly inside the try: any surprise here resolves
                    # the group's futures instead of killing the thread
                    x = np.zeros((B, target), np.float32)
                    for row, (wav, _) in enumerate(group):
                        x[row, :wav.shape[-1]] = wav
                    ticket = fwd.launch(x)
                except Exception as e:
                    for _, fut in group:
                        _resolve(fut, exc=e)
                    continue
                if fwd.graph is not None:
                    self.stats["replays"] += len(self._replicas)
                # bounded handoff: blocks while pipeline_depth batches are
                # in flight, so requests pile up and the next batch
                # coalesces full at once
                self._inflight.put((fwd, ticket, group))

    # -- resolver thread ---------------------------------------------------

    def _resolve_loop(self):
        # one batch at a time, oldest first: waiting on the newest batch
        # before answering the oldest would stop the copies overlapping
        # the card's work
        while True:
            item = self._inflight.get()
            if item is None:
                return
            fwd, ticket, group = item
            try:
                est = fwd.collect(ticket)  # waits on the batch's event
            except Exception as e:
                for _, fut in group:
                    _resolve(fut, exc=e)
                continue
            for row, (wav, fut) in enumerate(group):
                _resolve(fut, result=trim_renorm(wav, est[row]))
