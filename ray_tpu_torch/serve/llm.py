"""Continuous-batched LLM serving, PyTorch/CUDA — paged KV edition.

Counterpart of `ray_tpu/serve/llm.py`: the same engines, scheduling,
allocator, prefix cache and pipeline, over `models/decoding.py`'s torch
functions.  New requests are admitted into free slots between decode
steps (iteration-level scheduling), so one fixed-shape dispatch serves
everything.

`PagedBatcher` (the default engine) stores KV in a shared pool of
fixed-size blocks addressed through per-request block tables: admission
allocates exactly ceil((prompt + max_new) / block_size) blocks, decode
attends through the table with the ragged paged-attention CUDA kernel
(ops/paged_attention.py), and a refcounted allocator makes blocks
SHAREABLE.  On top sits an SGLang-style radix/prefix cache: retired
requests leave their full prompt blocks in a radix tree, a new prompt's
longest cached block-prefix is refcount-shared into its table, and
device prefill runs only the uncached suffix.  Cold blocks are
LRU-evicted under pressure; when the pool is empty a new request
*queues* for blocks (backpressure), and finish-reason "cache" is
reserved for a single request that exceeds the whole pool (or its
table).  `ContinuousBatcher` is the dense engine (a max_len KV slab per
slot), the `paged_kv=False` escape hatch.

Pipelining (shared by both engines): the engine keeps up to
`pipeline_depth` dispatches in flight; each dispatch's token outputs are
copied to pinned host memory with a non-blocking copy and a CUDA event
recorded after it, and the processor thread waits on that event (never
on the whole device) before it reads — so the card computes chunk k+1
while chunk k's tokens are processed.  Every dispatch is tagged with its
(slot → request) ownership at dispatch time; a slot retired while later
dispatches were in flight just has its extra tokens dropped, and
in-order processing makes the attribution exact.

Multiplexing (paged engine): requests tagged with a `model_id` hot-swap
LoRA adapters merged into the base weights (`serve/multiplex.py`
`merge_adapter`), LRU-resident up to `max_resident_models`; same shapes,
new weights, so the decode path and B4's inputs (the KV pool) are
untouched, and each model keys its own radix tree so prefix reuse never
crosses models.  A model mismatch at the head of the queue drains the
engine, then swaps; an unknown adapter fails its request, not the
engine.

Not ported yet: adapter specs given as object-store refs, the
KV/prefix-cache metrics (`_get_kv_metrics` returns None) and deployment
through the serve runtime (all ROADMAP A3) — this slice's entry points
are `LLMDeployment` / `PagedBatcher` in process.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ray_tpu_torch.devtools import leaksan

_STREAM_END = object()


@dataclass
class _Request:
    prompt: List[int]
    max_new: int
    done: threading.Event = field(default_factory=threading.Event)
    tokens: List[int] = field(default_factory=list)
    ttft_s: float = 0.0
    # TTFT decomposition: queue_s = submit -> slot admission (engine
    # queue wait), prefill_s = admission -> first token materialized
    # (device prefill + pipeline/transfer).  ttft_s = queue_s + prefill_s.
    queue_s: float = 0.0
    prefill_s: float = 0.0
    _t0: float = 0.0
    _admit_t: float = 0.0
    slot: int = -1
    error: Optional[Exception] = None
    # "eos" | "length" (hit max_new) | "cache" (request exceeded the KV
    # pool/table; with the paged engine transient exhaustion QUEUES the
    # request instead — "cache" means this one request can never fit)
    finish_reason: str = ""
    # Prefix cache (paged engine): the model the request routed with,
    # and whether admission reused cached blocks.
    model_id: str = ""
    cache_hit: bool = False
    cached_tokens: int = 0
    _prefix_len: int = 0
    # Paged bookkeeping: max total positions (prompt + generated) this
    # request's block allocation covers (0 = dense engine: global cap),
    # and the pool blocks it holds a reference on.
    _pos_cap: int = 0
    _blocks: List[int] = field(default_factory=list)
    _blocks_freed: bool = False
    # Set for streaming consumers: tokens are ALSO pushed here as the
    # engine processes decode reads, ending with _STREAM_END.
    stream_q: Optional["queue.Queue"] = None

    def stream(self, timeout: float = 300.0) -> Iterator[int]:
        """Yield tokens as they are decoded (requires submit(...,
        streaming=True))."""
        if self.stream_q is None:
            raise RuntimeError("request was not submitted as streaming")
        while True:
            item = self.stream_q.get(timeout=timeout)
            if item is _STREAM_END:
                if self.error is not None:
                    raise self.error
                return
            yield item


class _HostCopy:
    """A device->host copy started at dispatch time (the counterpart of
    jax's `copy_to_host_async`): a non-blocking copy into pinned host
    memory and a CUDA event recorded after it on the same stream.
    `wait()` blocks on that event before the buffer is read — reading
    the pinned buffer without it would race the copy."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor) -> None:
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype,
                                    pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host, self.event = t, None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class ContinuousBatcher:
    """Slot-based continuous batching engine (host loop + device steps).

    Thread-safe submit(); a dedicated engine thread interleaves
    admissions (batched prefill_insert) with chunked decode_steps
    dispatches, keeping `pipeline_depth` dispatches in flight.

    This is the DENSE engine (per-slot max_len KV slabs) — the
    `paged_kv=False` escape hatch.  PagedBatcher below subclasses the
    pipeline/submit machinery and swaps the cache for a paged block
    pool with prefix caching.  The device is the one `params` live on.
    """

    supports_multiplex = False

    def __init__(self, params, cfg, num_slots: int = 8,
                 max_len: int = 512, prompt_pad: int = 64,
                 eos_id: Optional[int] = None,
                 decode_chunk: int = 8,
                 pipeline_depth: int = 2,
                 max_queue: int = 0) -> None:
        from ray_tpu_torch.models import decoding
        self._dec = decoding
        self.device = params["tok_embed"].device
        if self.device.type == "cuda":
            # The f32 logits and the f32 reference path must stay f32:
            # no TF32 in matmuls or convolutions (process-wide).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.prompt_pad = prompt_pad
        self.eos_id = eos_id
        # Admission backstop: submit() sheds (typed rejection) once
        # this many requests are queued ahead of slot admission.
        # 0 = unlimited.  The check runs BEFORE anything touches the
        # KV path, so a shed request never allocates blocks or
        # queries the prefix cache.
        self.max_queue = max(int(max_queue), 0)
        # SLO windows (slo_snapshot): engine TTFT samples and
        # inter-token latency derived from decode entry processing
        # cadence.  Guarded by _slo_lock (processor thread appends,
        # caller threads snapshot).
        self._slo_lock = threading.Lock()
        self._ttft_win: deque = deque(maxlen=128)
        self._itl_win: deque = deque(maxlen=256)
        self._last_entry_t: Optional[float] = None
        # Tokens decoded per device dispatch: >1 amortizes dispatch
        # overhead at the cost of admission/EOS granularity.
        self.decode_chunk = max(decode_chunk, 1)
        self.pipeline_depth = max(pipeline_depth, 1)
        self.caches = self._init_caches(cfg, num_slots, max_len)
        # Slot ownership/length AT DISPATCH TIME (the engine's view of
        # the device); processing updates the per-request state.
        self._owner: List[Optional[_Request]] = [None] * num_slots
        self._disp_len = [0] * num_slots
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        # In-flight dispatches, oldest first:
        #   ("fused", (firsts, dtoks), (admitted, pairs))
        #   ("decode", (dtoks,), (None, pairs))
        # each device output wrapped in a _HostCopy.
        self._inflight: deque = deque()
        self._narrow_width = min(4, num_slots)
        # Packed-upload width (prefill_decode_packed wire format).
        self._pack_w = self._packed_width(prompt_pad, num_slots)
        self._shutdown = False
        self._work = threading.Event()
        self.steps = 0
        # Device-resident active mask, re-uploaded only when it changes.
        self._active_key: Optional[bytes] = None
        self._active_dev = None
        # Dispatcher/processor split: result processing must not
        # serialize with dispatch submission.  _state_lock guards
        # _owner/_disp_len (both threads mutate them); _inflight moves
        # entries from dispatcher to processor; _slots_sem bounds the
        # pipeline depth.
        self._state_lock = threading.Lock()
        self._proc_wake = threading.Event()
        self._slots_sem = threading.Semaphore(self.pipeline_depth)
        self._thread = threading.Thread(target=self._engine_loop,
                                        daemon=True, name="rtt-llm")
        self._thread.start()
        self._proc_thread = threading.Thread(
            target=self._process_loop, daemon=True, name="rtt-llm-proc")
        self._proc_thread.start()
        leaksan.track_thread(self._thread)
        leaksan.track_thread(self._proc_thread)

    # -- engine-variant hooks (overridden by PagedBatcher) -----------------
    def _init_caches(self, cfg, num_slots: int, max_len: int):
        return self._dec.init_caches(cfg, num_slots, max_len,
                                     device=self.device)

    def _packed_width(self, prompt_pad: int, num_slots: int) -> int:
        return max(prompt_pad + 3, num_slots)

    def _req_cap(self, req: "_Request") -> int:
        """Max total positions (prompt + generated) for this request:
        the dense engine's global cache cap, or the request's own
        block allocation for the paged engine."""
        return req._pos_cap or self._cap()

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host->device transfer (pinned, non-blocking on CUDA)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _warmup(self) -> None:
        """Run every dispatch shape once (both fused widths + the
        decode-only chunk + the single step) before the first request,
        which also builds the kernels."""
        active = torch.zeros((self.num_slots,), dtype=torch.bool,
                             device=self.device)
        for N in sorted({self._narrow_width, self.num_slots}):
            packed = np.zeros((N + 1, self._pack_w), np.int32)
            packed[:N, self.prompt_pad + 1] = np.arange(N)
            self.caches, _, _ = self._dec.prefill_decode_packed(
                self.params, self.caches, self._upload(packed),
                self.cfg, self.decode_chunk, self.prompt_pad)
        if self.decode_chunk > 1:
            self.caches, toks = self._dec.decode_steps(
                self.params, self.caches, active, self.cfg,
                self.decode_chunk)
            toks.cpu()
        # Single-step shape too: the near-cache tail falls back to it.
        self.caches, toks = self._dec.decode_step(
            self.params, self.caches, active, self.cfg)
        toks.cpu()

    # -- public ------------------------------------------------------------
    def queue_depth(self) -> int:
        """Requests queued ahead of slot admission (not yet decoding).
        The paged engine adds its dispatcher-side waiting deque."""
        return self._pending.qsize()

    def slo_snapshot(self) -> Dict[str, Any]:
        """The engine-side SLO view: engine queue depth, TTFT p95, and
        decode inter-token latency p95 over the rolling time-decayed
        windows."""
        from ray_tpu_torch.serve._admission import _SLO_WINDOW_S, _p95_ms

        def p95(xs):
            v = _p95_ms(xs)
            return round(v, 3) if v is not None else None

        cutoff = time.time() - _SLO_WINDOW_S
        with self._slo_lock:
            ttfts = [v for t, v in self._ttft_win if t >= cutoff]
            itls = [v for t, v in self._itl_win if t >= cutoff]
        return {"queue_depth": self.queue_depth(),
                "ttft_p95_ms": p95(ttfts),
                "itl_p95_ms": p95(itls)}

    def submit(self, prompt: List[int], max_new: int = 32,
               streaming: bool = False, model_id: str = "") -> _Request:
        """Enqueue a request.  `model_id` selects a multiplexed adapter
        (paged engine only).

        With `max_queue` set, a submit that finds that many requests
        already queued raises the typed RequestRejectedError HERE —
        before the request touches the engine at all (a shed request
        must never query the prefix cache or hold KV blocks)."""
        if self.max_queue and self.queue_depth() >= self.max_queue:
            from ray_tpu_torch.serve._admission import RequestRejectedError
            raise RequestRejectedError(
                deployment="llm-engine", reason="queue_full",
                retry_after_s=0.5)
        if len(prompt) > self.prompt_pad:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds "
                             f"prompt budget {self.prompt_pad}")
        if model_id and not self.supports_multiplex:
            raise ValueError(
                "model multiplexing requires the paged engine "
                "(paged_kv=True)")
        req = _Request(prompt=list(prompt), max_new=max_new,
                       model_id=model_id,
                       stream_q=queue.Queue() if streaming else None)
        req._t0 = time.time()
        self._pending.put(req)
        self._work.set()
        return req

    def generate(self, prompt: List[int], max_new: int = 32,
                 timeout: float = 300.0,
                 model_id: str = "") -> Dict[str, Any]:
        req = self.submit(prompt, max_new, model_id=model_id)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return {"tokens": req.tokens, "ttft_s": req.ttft_s,
                "queue_s": req.queue_s, "prefill_s": req.prefill_s,
                "cache_hit": req.cache_hit,
                "cached_tokens": req.cached_tokens,
                "finish_reason": req.finish_reason}

    def generate_stream(self, prompt: List[int], max_new: int = 32,
                        timeout: float = 300.0,
                        model_id: str = "") -> Iterator[int]:
        """Blocking token iterator."""
        req = self.submit(prompt, max_new, streaming=True,
                          model_id=model_id)
        return req.stream(timeout=timeout)

    def stop(self) -> None:
        self._shutdown = True
        self._work.set()
        self._proc_wake.set()
        # Join the engine threads: both loops observe _shutdown at the
        # next iteration, so this is bounded by one warmup/dispatch.
        for t in (self._thread, self._proc_thread):
            if t is not threading.current_thread():
                t.join(timeout=120.0)
            # Only a thread that actually EXITED leaves the ledger: a
            # join that timed out (wedged dispatch) must stay visible.
            if not t.is_alive():
                leaksan.discharge_thread(t)
        # Terminal discharge: anything still owned/queued can never
        # finish now that the loops are gone; the paged _fail_all also
        # drops the prefix cache, so a stopped engine holds zero blocks.
        self._fail_all(RuntimeError("engine stopped"))

    # -- engine ------------------------------------------------------------
    def _push_token(self, req: _Request, tok: int) -> None:
        req.tokens.append(tok)
        if req.stream_q is not None:
            req.stream_q.put(tok)

    def _finished(self, req: _Request, tok: int) -> bool:
        if self.eos_id is not None and tok == self.eos_id:
            req.finish_reason = "eos"
            return True
        if len(req.tokens) >= req.max_new:
            req.finish_reason = "length"
            return True
        return False

    def _retire(self, slot: int, req: _Request) -> None:
        with self._state_lock:
            if self._owner[slot] is req:
                self._owner[slot] = None
        req.done.set()
        if req.stream_q is not None:
            req.stream_q.put(_STREAM_END)

    def _finish_request(self, req: "_Request",
                        error: Optional[Exception] = None,
                        reason: str = "") -> None:
        """Terminal bookkeeping for a request that never reaches
        _retire (failed, rejected, or swept before getting a slot)."""
        if error is not None:
            req.error = error
        if reason:
            req.finish_reason = reason
        req.done.set()
        if req.stream_q is not None:
            req.stream_q.put(_STREAM_END)

    def _fail_all(self, e: Exception) -> None:
        # Snapshot the slot table under _state_lock (the dispatcher
        # mutates _owner concurrently), then retire outside it —
        # _retire takes the lock itself.
        with self._state_lock:
            owned = [(i, req) for i, req in enumerate(self._owner)
                     if req is not None]
        for i, req in owned:
            req.error = e
            self._retire(i, req)
        while not self._pending.empty():
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            self._finish_request(req, error=e)
        # Drain (don't clear): each in-flight entry holds a pipeline
        # permit that must come back, and popleft is atomic against a
        # concurrently-draining processor.
        while True:
            try:
                self._inflight.popleft()
            except IndexError:
                break
            self._slots_sem.release()

    # True cache capacity: position max_len - 1 is the last decodable
    # token (the scatter at the final step writes position max_len - 2).
    def _cap(self) -> int:
        return self.max_len - 1

    def _tail_throttle(self, req: "_Request") -> bool:
        """Whether nearing this request's cap must force single-token
        dispatches.  Dense: always — the cap is the physical cache
        end, and overshooting it a chunk early truncates the request."""
        return True

    def _drained(self, slot: int, req: "_Request") -> bool:
        """Everything `req` needs is already dispatched (caller holds
        _state_lock)."""
        gen = 1 + self._disp_len[slot] - len(req.prompt)
        return (gen >= req.max_new
                or self._disp_len[slot] >= self._req_cap(req))

    def _pop_admissions(self, free: List[int],
                        tail: bool) -> List[tuple]:
        """Pair waiting requests with free slots: [(slot, req)].
        PagedBatcher overrides this with allocator/radix admission."""
        batch: List[tuple] = []
        if free and not tail and not self._pending.empty():
            while len(batch) < len(free):
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
                batch.append((free[len(batch)], req))
        return batch

    def _fill_pad_rows(self, packed, n_batch: int, N: int,
                       admitted: List[tuple], slot_col: int) -> None:
        # Rows without a request still need DISTINCT target slots
        # (their write is a rewrite of existing contents): duplicate
        # scatter indices have undefined order and could clobber a real
        # insert.
        used = {s for _, s, _ in admitted}
        remaining = [s for s in range(self.num_slots) if s not in used]
        for row in range(n_batch, N):
            packed[row, slot_col] = remaining[row - n_batch]

    def _fused_dispatch(self, batch: List[tuple], active, chunk: int):
        """Pack + launch the fused prefill/decode for `batch`
        ([(slot, req)]); returns (first, dtoks, admitted).  The packed
        wire format and kernel are the engine-variant parts."""
        # Two dispatch widths (narrow + full), both run at warm-up.
        N = (self._narrow_width
             if len(batch) <= self._narrow_width
             else self.num_slots)
        P = self.prompt_pad
        packed = np.zeros((N + 1, self._pack_w), np.int32)
        admitted = []
        for row, (slot, req) in enumerate(batch):
            packed[row, :len(req.prompt)] = req.prompt
            packed[row, P] = len(req.prompt)
            packed[row, P + 1] = slot
            packed[row, P + 2] = 1
            admitted.append((row, slot, req))
        self._fill_pad_rows(packed, len(batch), N, admitted, P + 1)
        packed[N, :self.num_slots] = active
        self.caches, first, dtoks = self._dec.prefill_decode_packed(
            self.params, self.caches, self._upload(packed),
            self.cfg, chunk, P)
        return first, dtoks, admitted

    def _decode_dispatch(self, chunk: int):
        """Decode-only device step for every slot; returns dtoks
        [chunk, B] (engine-variant kernel)."""
        if chunk > 1:
            self.caches, dtoks = self._dec.decode_steps(
                self.params, self.caches, self._active_dev,
                self.cfg, chunk)
            return dtoks
        self.caches, tok = self._dec.decode_step(
            self.params, self.caches, self._active_dev, self.cfg)
        return tok[None]

    def _post_admit(self, admitted: List[tuple]) -> None:
        """Engine-variant bookkeeping after a fused dispatch launched
        (PagedBatcher: radix insertion)."""

    def _dispatch(self) -> bool:
        """One device dispatch per tick: chunked decode of every live
        slot, with any waiting admissions FUSED into the same dispatch
        (prefill_decode_packed).  The pipeline bookkeeping here is
        shared by both engines; the pack format, kernels, and admission
        policy are the _pop_admissions/_fused_dispatch/_decode_dispatch/
        _post_admit hooks."""
        with self._state_lock:
            # A slot is admittable when empty OR "drained": every token
            # its current request needs is already covered by in-flight
            # dispatches (predictable for length/cache finishes — the
            # dispatcher knows max_new).  Re-admitting a drained slot
            # immediately removes the retire->readmit pipeline bubble;
            # the old request's entries still deliver its tokens, and
            # in-order device execution puts the new prefill after the
            # old request's last chunk.  With an eos_id the finish point
            # is NOT predictable, so only empty slots qualify.
            free = [i for i, r in enumerate(self._owner)
                    if r is None or (self.eos_id is None
                                     and self._drained(i, r))]
            live = [(i, r) for i, r in enumerate(self._owner)
                    if r is not None
                    and self._disp_len[i] < self._req_cap(r)]
            # Near the cache end, fall back to single-token dispatches
            # (and no admissions) so requests run all the way to
            # max_len - 1 instead of being truncated a chunk early.
            tail = any(self._disp_len[i] + self.decode_chunk
                       > self._req_cap(r) and self._tail_throttle(r)
                       for i, r in live)
        chunk = 1 if tail else self.decode_chunk
        batch = self._pop_admissions(free, tail)
        # Slots whose request already has max_new covered by in-flight
        # dispatches stay in the batch anyway — the decode is
        # fixed-shape, so excluding them saves nothing, while skipping
        # the dispatch when "nothing needs tokens" drains the pipeline.
        # Their extra tokens are dropped at processing time.
        if not live and not batch:
            return False
        active = np.zeros((self.num_slots,), bool)
        for i, _ in live:
            active[i] = True

        if batch:
            # Admission happens HERE (slots are committed); stamp it
            # before the prefill dispatch so dispatch time lands in
            # prefill_s, not queue_s.
            admit_t = time.time()
            try:
                first, dtoks, admitted = self._fused_dispatch(
                    batch, active, chunk)
            except Exception as e:
                # The batch is already out of _waiting/_pending with
                # KV blocks held, but not yet in _owner — _fail_all
                # can't reach it.  Fail + retire each request here
                # (retire frees paged blocks) before re-raising into
                # the engine loop's recovery path.
                for slot, req in batch:
                    req.error = e
                    self._retire(slot, req)
                raise
            with self._state_lock:
                for _, slot, req in admitted:
                    self._owner[slot] = req
                    req._admit_t = admit_t
                    # prompt + the chunk the fused step decodes for it
                    self._disp_len[slot] = len(req.prompt) + chunk
            self._post_admit(admitted)
            pairs = live + [(slot, req) for _, slot, req in admitted]
            entry = ("fused", (_HostCopy(first), _HostCopy(dtoks)),
                     (admitted, pairs))
        else:
            key = active.tobytes()
            if key != self._active_key:
                self._active_key = key
                self._active_dev = self._upload(active)
            entry = ("decode", (_HostCopy(self._decode_dispatch(chunk)),),
                     (None, live))
        admitted_slots = ({slot for _, slot, _ in entry[2][0]}
                          if entry[0] == "fused" else set())
        with self._state_lock:
            for i, _ in live:
                # A drained-readmitted slot already had its _disp_len
                # reset to prompt + chunk above; adding chunk again
                # would report it "drained" one chunk early.
                if i not in admitted_slots:
                    self._disp_len[i] += chunk
        self._inflight.append(entry)
        self._proc_wake.set()
        self.steps += chunk
        return True

    def _process_entry(self, entry) -> None:
        kind, copies, (admitted, pairs) = entry
        if kind == "fused":
            firsts = copies[0].wait()
            # Stamped once the first tokens are on the host, so TTFT
            # includes the device prefill it waited for.
            now = time.time()
            for row, slot, req in admitted:
                req.ttft_s = now - req._t0
                admit = req._admit_t or now
                req.queue_s = max(admit - req._t0, 0.0)
                req.prefill_s = max(now - admit, 0.0)
                req.slot = slot
                tok = int(firsts[row])
                self._push_token(req, tok)
                if self._finished(req, tok):
                    self._retire(slot, req)
            rows = copies[1].wait()
        else:
            rows = copies[0].wait()
        # SLO windows: TTFT for this entry's admissions; an inter-token
        # latency sample from the entry cadence — each entry carries
        # len(rows) decode steps.
        t_proc = time.time()
        with self._slo_lock:
            for _, _, req in (admitted or ()):
                self._ttft_win.append((t_proc, req.ttft_s))
            if pairs:
                if self._last_entry_t is not None:
                    self._itl_win.append(
                        (t_proc,
                         max(t_proc - self._last_entry_t, 0.0)
                         / max(len(rows), 1)))
                self._last_entry_t = t_proc
        # Column-major with one C-level tolist() + bulk extends: slots
        # are independent streams, so slot-by-slot processing is
        # equivalent to token-major order.
        cols = rows.T.tolist()                # [B][chunk]
        for slot, req in pairs:
            if req.done.is_set():
                continue                      # finished by an earlier entry
            cap = self._req_cap(req)
            col = cols[slot]
            take = min(len(col),
                       req.max_new - len(req.tokens),
                       cap - len(req.prompt) - len(req.tokens))
            seg = col[:max(take, 0)]
            if self.eos_id is not None and self.eos_id in seg:
                seg = seg[:seg.index(self.eos_id) + 1]
                req.finish_reason = "eos"
            req.tokens.extend(seg)
            if req.stream_q is not None:
                for t in seg:
                    req.stream_q.put(t)
            if req.finish_reason == "eos":
                self._retire(slot, req)
            elif len(req.tokens) >= req.max_new:
                req.finish_reason = "length"
                self._retire(slot, req)
            elif len(req.prompt) + len(req.tokens) >= cap:
                # Dispatch stops at the cap margin, so retire here too
                # or a capped slot would stall unretired.
                req.finish_reason = "cache"
                self._retire(slot, req)

    def _engine_loop(self) -> None:
        self._warmed = False
        try:
            self._warmup()
        except Exception as e:
            self._fail_all(e)
        self._warmed = True
        while not self._shutdown:
            try:
                # Acquire a pipeline slot, then dispatch; the processor
                # releases slots as it drains entries.
                if not self._slots_sem.acquire(timeout=0.05):
                    continue
                if not self._dispatch():
                    self._slots_sem.release()
                    self._work.wait(timeout=0.05)
                    self._work.clear()
            except Exception as e:
                # An engine failure (e.g. device error) must surface to
                # every waiting caller, not die with the thread.
                self._slots_sem.release()
                self._fail_all(e)
                time.sleep(0.1)

    def _process_loop(self) -> None:
        while not self._shutdown:
            try:
                entry = self._inflight.popleft()
            except IndexError:
                # Idle: break the ITL cadence chain, or the first
                # entry after an idle gap would record (gap / chunk)
                # as an inter-token-latency sample.
                with self._slo_lock:
                    self._last_entry_t = None
                self._proc_wake.wait(timeout=0.05)
                self._proc_wake.clear()
                continue
            try:
                self._process_entry(entry)
            except Exception as e:
                self._fail_all(e)
                time.sleep(0.1)
            finally:
                # One permit per drained entry, whether it processed
                # cleanly or died — pipeline depth must never shrink.
                self._slots_sem.release()
                self._work.set()


# ===========================================================================
# Paged KV engine
# ===========================================================================
def _get_kv_metrics() -> Optional[Dict[str, Any]]:
    """KV block / prefix-cache metric cells.  The metrics plane is not
    ported yet, so there are none; every caller tolerates None."""
    return None


class BlockAllocator:
    """Refcounted fixed-size KV block allocator over pool ids
    1..num_blocks (id 0 is the kernel's reserved scratch block and is
    never handed out).

    A block is in exactly one of three states:
      used   — refcount > 0 (held by >= 1 active request);
      cached — refcount == 0 but retained by the prefix radix tree
               (reusable by a future prefix hit, evictable under
               pressure);
      free   — in the free list.
    NOT thread-safe; the engine serializes access with its _kv_lock.
    """

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 1:
            raise ValueError("paged KV pool needs at least one block")
        self.num_blocks = num_blocks
        # pop() hands out low ids first (cosmetic, aids debugging).
        self._free: List[int] = list(range(num_blocks, 0, -1))
        self._ref: Dict[int, int] = {}
        self._cached: set = set()

    def available(self) -> int:
        return len(self._free)

    # Leak-ledger hooks (RAY_TPU_LEAKSAN=1): a block is "live" from
    # the moment it leaves the free list until it returns.  Keys
    # include id(self) so two engines' pools never collide.
    def _ls_reg(self, bid: int) -> None:
        leaksan.register("kv_block", (id(self), bid))

    def _ls_dis(self, bid: int) -> None:
        leaksan.discharge("kv_block", (id(self), bid))

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks at refcount 1, or None (caller evicts or
        queues — never a partial allocation)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
            if leaksan._ENABLED:
                self._ls_reg(b)
        return out

    def incref(self, bid: int) -> None:
        self._ref[bid] = self._ref.get(bid, 0) + 1

    def decref(self, bid: int) -> None:
        r = self._ref.get(bid)
        if r is None or r <= 0:
            raise RuntimeError(
                f"KV block {bid} double-free (refcount {r!r})")
        r -= 1
        if r == 0 and bid not in self._cached:
            del self._ref[bid]
            self._free.append(bid)
            if leaksan._ENABLED:
                self._ls_dis(bid)
        else:
            self._ref[bid] = r

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def mark_cached(self, bid: int) -> None:
        """The radix tree now retains this block (refcount-0 keeps it
        out of the free list until evicted)."""
        self._cached.add(bid)

    def release_cached(self, bid: int) -> None:
        """The radix tree evicted this block; if no request holds it,
        it returns to the free list."""
        self._cached.discard(bid)
        if self._ref.get(bid, 0) == 0:
            self._ref.pop(bid, None)
            self._free.append(bid)
            if leaksan._ENABLED:
                self._ls_dis(bid)

    def counts(self) -> Dict[str, int]:
        used = sum(1 for r in self._ref.values() if r > 0)
        cached = sum(1 for b in self._cached
                     if self._ref.get(b, 0) == 0)
        return {"used": used, "cached": cached,
                "free": len(self._free)}


class _RadixNode:
    __slots__ = ("children", "parent", "key", "block", "last_used")

    def __init__(self, parent=None, key=None, block=None):
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.parent = parent
        self.key = key
        self.block = block
        self.last_used = 0


class RadixCache:
    """Radix/prefix tree over FULL KV blocks for one model id
    (SGLang-style).  Each edge is one block's worth of tokens; a path
    from the root spells a prompt prefix and its nodes carry the
    physical blocks holding that prefix's KV.  Only whole blocks are
    shareable — the partial tail block of a prompt stays private, so
    decode writes never touch shared state.  NOT thread-safe (engine
    _kv_lock)."""

    def __init__(self, block_size: int, clock=None) -> None:
        self.block_size = block_size
        self.root = _RadixNode()
        # LRU clock: the engine passes ONE shared counter to all its
        # trees so last_used values are comparable in the global
        # eviction sort.
        self._clock = clock
        self._tick = 0
        self.size = 0          # cached nodes/blocks in this tree

    def _touch(self, node: "_RadixNode") -> None:
        if self._clock is not None:
            node.last_used = self._clock()
        else:
            self._tick += 1
            node.last_used = self._tick

    def match(self, tokens: List[int]) -> List[int]:
        """Longest cached block-prefix of `tokens`, capped at
        len(tokens) - 1 so at least one token is always left for the
        suffix prefill (the request needs fresh last-position logits).
        Returns the physical block ids, root-first."""
        bs = self.block_size
        out: List[int] = []
        node = self.root
        limit = (len(tokens) - 1) // bs
        for i in range(limit):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                break
            self._touch(child)
            out.append(child.block)
            node = child
        return out

    def insert(self, tokens: List[int], blocks: List[int],
               allocator: BlockAllocator) -> int:
        """Cache every full-block chunk of `tokens` along one path.
        `blocks` is the request's block table (position-ordered), so
        blocks[i] holds chunk i's KV.  Existing nodes win collisions
        (the caller's duplicate block stays private and is freed at
        retire); new nodes mark their block cached.  Returns the
        number of NEW nodes."""
        bs = self.block_size
        node = self.root
        added = 0
        n = min(len(tokens) // bs, len(blocks))
        for i in range(n):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                child = _RadixNode(parent=node, key=chunk,
                                   block=blocks[i])
                node.children[chunk] = child
                allocator.mark_cached(blocks[i])
                self.size += 1
                added += 1
            # else: a same-prefix race within one admission batch keeps
            # the cached block; the caller keeps its private copy.
            self._touch(child)
            node = child
        return added

    def evictable(self) -> List[tuple]:
        """(last_used, node) for every LEAF — the LRU eviction
        candidates.  Leaf-only eviction keeps the prefix property: a
        cached chunk's ancestors stay cached."""
        out = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self.root or node.children:
                continue
            out.append((node.last_used, node))
        return out

    def remove_leaf(self, node: "_RadixNode",
                    allocator: BlockAllocator) -> None:
        if node.children or node.parent is None:
            raise RuntimeError("can only evict leaf radix nodes")
        del node.parent.children[node.key]
        node.parent = None
        allocator.release_cached(node.block)
        self.size -= 1


class PagedBatcher(ContinuousBatcher):
    """Paged-KV continuous batcher: block-pool cache + radix prefix
    cache + multiplexed adapter hot-swap (see module docstring).

    Inherits the pipelined dispatch/process machinery and swaps the
    cache layer: admission allocates refcounted blocks (evicting cold
    cached blocks, then QUEUEING under pressure), prefill runs only
    the prompt's uncached suffix via paged_prefill_decode_packed, and
    decode attends through block tables with the ragged paged-attention
    kernel (`attn_impl`: "auto" = the CUDA kernel on the card and the
    plain version on the CPU; "kernel" / "reference" force one).

    `adapters={model_id: spec}` (see `multiplex.merge_adapter`) are
    merged into `params` as given — f32 parameters merge in f32, as the
    JAX engine does — and each merged model is cast for serving
    (`decoding.serving_params`), sharing the leaves it leaves untouched.
    """

    supports_multiplex = True

    def __init__(self, params, cfg, num_slots: int = 8,
                 max_len: int = 512, prompt_pad: int = 64,
                 eos_id: Optional[int] = None,
                 decode_chunk: int = 8,
                 pipeline_depth: int = 2,
                 kv_block_size: Optional[int] = None,
                 kv_num_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 adapters: Optional[Dict[str, Any]] = None,
                 max_resident_models: int = 3,
                 attn_impl: str = "auto",
                 max_queue: int = 0) -> None:
        from ray_tpu_torch._private.config import config
        from ray_tpu_torch.models import decoding
        self.block_size = int(kv_block_size or config.kv_block_size)
        if self.block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        self.table_width = decoding.paged_table_width(
            max_len, self.block_size)
        auto_blocks = num_slots * self.table_width
        self.num_blocks = int(kv_num_blocks or config.kv_num_blocks
                              or auto_blocks)
        if prefix_cache is None:
            prefix_cache = bool(config.prefix_cache_enabled)
        self.prefix_cache_enabled = prefix_cache
        policy = str(config.kv_eviction_policy).lower()
        if policy != "lru":
            raise ValueError(
                f"unknown kv_eviction_policy {policy!r} (only 'lru')")
        # All engine-state below is shared between the dispatcher and
        # processor threads -> guarded by _kv_lock (allocator, radix
        # trees, counters).  _waiting is dispatcher-only: other
        # threads hand work to it through _pending and failures
        # through _waiting_fail, never by mutating the deque.
        self._kv_lock = threading.Lock()
        # Suffix-prefill width tiers: a prefix-cache hit leaves a short
        # uncached suffix, and running it through the full prompt_pad
        # wide prefill would spend the FLOPs the hit just saved.  Each
        # admission batch picks the narrowest width that fits its
        # longest suffix.
        self._suffix_pads = sorted({
            min(max(self.block_size, 16), prompt_pad), prompt_pad})
        self._alloc = BlockAllocator(self.num_blocks)
        self._radix: Dict[str, RadixCache] = {}
        # One LRU clock shared by every tree and a per-engine tag.
        _counter = itertools.count(1)
        self._radix_clock = lambda: next(_counter)
        self._engine_tag = f"{os.getpid():x}.{id(self):x}"
        self._waiting: deque = deque()
        self._waiting_fail: Optional[Exception] = None
        self._attn_impl = attn_impl
        self._adapters = dict(adapters or {})
        # The merge source (as given) only when there is something to
        # merge: otherwise f32 originals would stay alive beside their
        # serving casts.
        self._base_params = params if self._adapters else None
        params = decoding.serving_params(params, cfg)
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._models[""] = params
        self._max_resident = max(max_resident_models, 1)
        self._model_id = ""
        self._cache_queries = 0
        self._cache_hits = 0
        self._cache_hit_tokens = 0
        self._evictions = 0
        # super().__init__ LAST: it starts the engine threads, which
        # immediately use the state above.
        super().__init__(params, cfg, num_slots=num_slots,
                         max_len=max_len, prompt_pad=prompt_pad,
                         eos_id=eos_id, decode_chunk=decode_chunk,
                         pipeline_depth=pipeline_depth,
                         max_queue=max_queue)

    def queue_depth(self) -> int:
        # The dispatcher-side waiting deque holds requests already
        # popped from _pending but still blockless (backpressure).
        return self._pending.qsize() + len(self._waiting)

    # -- hooks -------------------------------------------------------------
    def _init_caches(self, cfg, num_slots: int, max_len: int):
        return self._dec.init_paged_caches(
            cfg, num_slots, self.num_blocks, self.block_size, max_len,
            device=self.device)

    def _packed_width(self, prompt_pad: int, num_slots: int) -> int:
        return max(prompt_pad + 4 + self.table_width, num_slots)

    def _warmup(self) -> None:
        active = torch.zeros((self.num_slots,), dtype=torch.bool,
                             device=self.device)
        for N in sorted({self._narrow_width, self.num_slots}):
            for P in self._suffix_pads:
                pw = max(P + 4 + self.table_width, self.num_slots)
                packed = np.zeros((N + 1, pw), np.int32)
                packed[:N, P + 2] = np.arange(N)
                self.caches, _, _ = \
                    self._dec.paged_prefill_decode_packed(
                        self.params, self.caches, self._upload(packed),
                        self.cfg, self.decode_chunk, P,
                        attn_impl=self._attn_impl)
        if self.decode_chunk > 1:
            self.caches, toks = self._dec.paged_decode_steps(
                self.params, self.caches, active, self.cfg,
                self.decode_chunk, attn_impl=self._attn_impl)
            toks.cpu()
        self.caches, toks = self._dec.paged_decode_step(
            self.params, self.caches, active, self.cfg,
            attn_impl=self._attn_impl)
        toks.cpu()

    # -- allocator / prefix cache ------------------------------------------
    def _radix_for(self, model_id: str) -> RadixCache:
        tree = self._radix.get(model_id)
        if tree is None:
            tree = self._radix[model_id] = RadixCache(
                self.block_size, clock=self._radix_clock)
        return tree

    def _evict_locked(self, need: int) -> int:
        """Free up to `need` blocks by LRU-evicting refcount-0 cached
        leaves across all radix trees (global LRU).  Caller holds
        _kv_lock."""
        freed = 0
        while freed < need:
            candidates = []
            for tree in self._radix.values():
                for last_used, node in tree.evictable():
                    if self._alloc.refcount(node.block) == 0:
                        candidates.append((last_used, node, tree))
            if not candidates:
                break
            candidates.sort(key=lambda c: c[0])
            for _, node, tree in candidates:
                if freed >= need:
                    break
                if node.children or node.parent is None:
                    continue       # a sibling eviction re-parented it
                tree.remove_leaf(node, self._alloc)
                freed += 1
                self._evictions += 1
        if freed:
            km = _get_kv_metrics()
            if km is not None:
                km["evictions"].inc(freed)
        return freed

    def _update_kv_gauges(self) -> None:
        km = _get_kv_metrics()
        if km is None:
            return
        with self._kv_lock:
            counts = self._alloc.counts()
        for state, n in counts.items():
            km["blocks"].set(n, tags={"state": state,
                                      "engine": self._engine_tag})

    def stop(self) -> None:
        super().stop()
        # Threads are joined now; remove this engine's gauge series.
        km = _get_kv_metrics()
        if km is not None:
            for state in ("used", "cached", "free"):
                km["blocks"].remove(tags={"state": state,
                                          "engine": self._engine_tag})

    def kv_stats(self) -> Dict[str, Any]:
        """Block-pool + prefix-cache occupancy."""
        with self._kv_lock:
            counts = self._alloc.counts()
            return {
                "block_size": self.block_size,
                "num_blocks": self.num_blocks,
                "blocks": counts,
                "prefix_cache": {
                    "enabled": self.prefix_cache_enabled,
                    "queries": self._cache_queries,
                    "hits": self._cache_hits,
                    "hit_tokens": self._cache_hit_tokens,
                    "evictions": self._evictions,
                    "cached_blocks": sum(t.size
                                         for t in self._radix.values()),
                },
                "models_resident": list(self._models),
                "model_id": self._model_id,
            }

    def resident_models(self) -> List[str]:
        # _kv_lock: _swap_model mutates _models on the dispatcher
        # thread while other threads read them.
        with self._kv_lock:
            return [m for m in self._models if m]

    # -- multiplexing ------------------------------------------------------
    def _load_model(self, model_id: str):
        """Merge an adapter into the base weights and cast what it
        changed for serving; untouched layer weights are the base
        model's own serving tensors.  (The base entry "" is always
        resident, so it never comes here.)"""
        spec = self._adapters.get(model_id)
        if spec is None:
            raise KeyError(f"unknown multiplexed model {model_id!r} "
                           f"(registered: {sorted(self._adapters)})")
        if not isinstance(spec, dict):
            raise NotImplementedError(
                f"adapter {model_id!r}: only dict specs are served; specs "
                "fetched from the object store need the actor runtime "
                "(ROADMAP Queue A, A3)")
        from ray_tpu_torch.serve.multiplex import merge_adapter
        base = self._base_params["layers"]
        merged = merge_adapter(self._base_params, spec)
        changed = {k: v for k, v in merged["layers"].items()
                   if v is not base[k]}
        cast = self._dec.serving_params({**merged, "layers": changed},
                                        self.cfg)
        return {**cast, "layers": {**self._models[""]["layers"],
                                   **cast["layers"]}}

    def _swap_model(self, model_id: str) -> None:
        """Hot-swap the active adapter: the LRU-missed merge, then new
        weights for the same decode path.  Caller (dispatcher)
        guarantees no live slots and an empty pipeline."""
        with self._kv_lock:
            params = self._models.get(model_id)
        if params is None:
            # Merge outside the lock; only the dict mutations below need
            # it (resident_models()/kv_stats() read _models from other
            # threads).
            params = self._load_model(model_id)
        with self._kv_lock:
            self._models[model_id] = params
            while len(self._models) > self._max_resident:
                # Never evict the base entry or the adapter being
                # swapped in (max_resident_models=1 would otherwise
                # evict it right here).
                for mid in self._models:
                    if mid != "" and mid != model_id:
                        del self._models[mid]
                        break
                else:
                    break
            self._models.move_to_end(model_id)
        self.params = params
        self._model_id = model_id

    def _can_swap(self) -> bool:
        with self._state_lock:
            busy = any(r is not None for r in self._owner)
        return not busy and not self._inflight

    def _tail_throttle(self, req: "_Request") -> bool:
        # Only a capacity-CLAMPED allocation needs the single-token
        # tail (it must run all the way to its cap before the "cache"
        # truncation).  An unclamped request ends exactly at max_new
        # via the processing take-bound, and its overshoot writes land
        # in private tail blocks / scratch block 0.
        return (req._pos_cap or 0) < len(req.prompt) + req.max_new

    # -- admission ---------------------------------------------------------
    def _try_admit(self, req: "_Request"):
        """Reserve blocks for `req`.  Returns True (admitted: blocks +
        prefix share installed on the request), None (transient
        exhaustion -> caller keeps it queued: backpressure), or
        "cache" (this single request exceeds the whole pool / its
        table and can NEVER be admitted)."""
        bs = self.block_size
        plen = len(req.prompt)
        want = plen + req.max_new
        # Positions are bounded by the table AND max_len: the table
        # rounds max_len UP to a block multiple, and decoding into
        # that rounding slack would run past the configured max_len.
        hard_cap = min(self.table_width * bs, self.max_len)
        alloc_tokens = min(want, hard_cap)
        total_blocks = -(-alloc_tokens // bs)
        if plen + 1 > hard_cap or total_blocks > self.num_blocks:
            return "cache"
        with self._kv_lock:
            prefix_blocks: List[int] = []
            if self.prefix_cache_enabled:
                prefix_blocks = self._radix_for(req.model_id).match(
                    req.prompt)
                # Hold the matched blocks BEFORE the eviction sweep so
                # it can never reclaim them out from under the hit.
                for b in prefix_blocks:
                    self._alloc.incref(b)
            try:
                need = total_blocks - len(prefix_blocks)
                if need > self._alloc.available():
                    self._evict_locked(need - self._alloc.available())
                if need > self._alloc.available():
                    for b in prefix_blocks:  # backpressure: undo hold
                        self._alloc.decref(b)
                    return None
                # Count queries/hits per ADMITTED request, not per
                # attempt (a backpressured request retries every tick).
                if self.prefix_cache_enabled:
                    self._cache_queries += 1
                    km = _get_kv_metrics()
                    if km is not None:
                        km["queries"].inc()
                    if prefix_blocks:
                        self._cache_hits += 1
                        self._cache_hit_tokens += len(prefix_blocks) * bs
                        if km is not None:
                            km["hits"].inc()
                new_blocks = self._alloc.alloc(need)
                req._blocks = prefix_blocks + (new_blocks or [])
            except Exception:
                # An exception between incref and handoff would leak
                # the prefix holds: _retire only frees blocks that made
                # it into req._blocks.
                for b in prefix_blocks:
                    self._alloc.decref(b)
                raise
        req._prefix_len = len(prefix_blocks) * bs
        req.cache_hit = bool(prefix_blocks)
        req.cached_tokens = req._prefix_len
        req._pos_cap = alloc_tokens
        return True

    def _admit(self, free: List[int]) -> List[tuple]:
        """FIFO admission with head-of-line backpressure: pop waiting
        requests while slots AND blocks last; a model mismatch at the
        head drains current-model slots, then hot-swaps."""
        admitted: List[tuple] = []
        while self._waiting and len(admitted) < len(free):
            req = self._waiting[0]
            if req.done.is_set():          # failed/cancelled upstream
                self._waiting.popleft()
                continue
            if req.model_id != self._model_id:
                if admitted or not self._can_swap():
                    break                  # drain, then swap next tick
                try:
                    self._swap_model(req.model_id)
                except Exception as e:     # unknown adapter, bad spec
                    self._waiting.popleft()
                    self._finish_request(req, error=e)
                    continue
            got = self._try_admit(req)
            if got is None:
                break                      # queue for blocks
            self._waiting.popleft()
            if got == "cache":
                # A single request larger than the whole pool: the
                # one case that still reports finish_reason "cache".
                self._finish_request(req, reason="cache")
                continue
            admitted.append((free[len(admitted)], req))
        return admitted

    def _retire(self, slot: int, req: "_Request") -> None:
        super()._retire(slot, req)
        with self._kv_lock:
            if req._blocks and not req._blocks_freed:
                req._blocks_freed = True
                for b in req._blocks:
                    self._alloc.decref(b)
        self._update_kv_gauges()

    def _flush_prefix_cache_locked(self) -> None:
        """Drop every cached prefix across all models' trees.  Refcount-0
        blocks return to the free list via release_cached; a block some
        racing admission still holds is merely unmarked and frees on its
        last decref.  Caller holds _kv_lock."""
        for tree in self._radix.values():
            stack = list(tree.root.children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                self._alloc.release_cached(node.block)
        self._radix = {}

    def _fail_all(self, e: Exception) -> None:
        super()._fail_all(e)
        # _post_admit inserts a batch's blocks into the radix tree at
        # LAUNCH, so a dispatch that later fails device-side leaves
        # cached blocks whose KV was never written; drop the whole
        # prefix cache so nothing can match unwritten KV.
        with self._kv_lock:
            self._flush_prefix_cache_locked()
        self._update_kv_gauges()
        # _waiting is dispatcher-only and _admit's peek-then-popleft
        # is not atomic, so a processor-thread failure must not drain
        # the deque here — park the error and let the dispatcher fail
        # the queue at its next _pop_admissions tick.
        if threading.current_thread() is self._thread \
                or (self._shutdown and not self._thread.is_alive()):
            # Dispatcher thread itself, or stop() after the join —
            # either way no dispatcher can race the deque.
            self._drain_waiting(e)
        else:
            self._waiting_fail = e

    def _drain_waiting(self, e: Exception) -> None:
        while self._waiting:
            req = self._waiting.popleft()
            if not req.done.is_set():
                self._finish_request(req, error=e)

    # -- dispatch hooks ----------------------------------------------------
    def _pop_admissions(self, free: List[int],
                        tail: bool) -> List[tuple]:
        # Apply a parked failure BEFORE pulling new submissions out of
        # _pending: only requests that were already waiting when the
        # engine failed get the error.
        err, self._waiting_fail = self._waiting_fail, None
        if err is not None:         # parked by a processor _fail_all
            self._drain_waiting(err)
        while True:                 # drain submit queue -> FIFO deque
            try:
                self._waiting.append(self._pending.get_nowait())
            except queue.Empty:
                break
        if free and not tail and self._waiting:
            return self._admit(free)
        return []

    def _fused_dispatch(self, batch: List[tuple], active, chunk: int):
        N = (self._narrow_width
             if len(batch) <= self._narrow_width
             else self.num_slots)
        max_suf = max(len(req.prompt) - req._prefix_len
                      for _, req in batch)
        P = next(p for p in self._suffix_pads if p >= max_suf)
        W = self.table_width
        packed = np.zeros((N + 1, max(P + 4 + W, self.num_slots)),
                          np.int32)
        admitted = []
        for row, (slot, req) in enumerate(batch):
            suffix = req.prompt[req._prefix_len:]
            packed[row, :len(suffix)] = suffix
            packed[row, P] = len(suffix)
            packed[row, P + 1] = req._prefix_len
            packed[row, P + 2] = slot
            packed[row, P + 3] = 1
            packed[row, P + 4:P + 4 + len(req._blocks)] = req._blocks
            admitted.append((row, slot, req))
        self._fill_pad_rows(packed, len(batch), N, admitted, P + 2)
        packed[N, :self.num_slots] = active
        self.caches, first, dtoks = \
            self._dec.paged_prefill_decode_packed(
                self.params, self.caches, self._upload(packed),
                self.cfg, chunk, P, attn_impl=self._attn_impl)
        return first, dtoks, admitted

    def _decode_dispatch(self, chunk: int):
        if chunk > 1:
            self.caches, dtoks = self._dec.paged_decode_steps(
                self.params, self.caches, self._active_dev,
                self.cfg, chunk, attn_impl=self._attn_impl)
            return dtoks
        self.caches, tok = self._dec.paged_decode_step(
            self.params, self.caches, self._active_dev, self.cfg,
            attn_impl=self._attn_impl)
        return tok[None]

    def _post_admit(self, admitted: List[tuple]) -> None:
        # Optimistic radix insertion AFTER the batch is packed:
        # in-order device execution guarantees these blocks are
        # written before any LATER dispatch's prefill gathers
        # them, but rows within THIS batch run concurrently — so
        # same-batch duplicates must miss (each keeps a private
        # copy) and only future admissions share.
        if self.prefix_cache_enabled:
            with self._kv_lock:
                for _, _, req in admitted:
                    self._radix_for(req.model_id).insert(
                        req.prompt, req._blocks, self._alloc)
        self._update_kv_gauges()


class LLMDeployment:
    """A PagedBatcher (default) or the dense ContinuousBatcher
    (`paged_kv=False`) over one model, in process.

    Parameters come from `params` (the port's layout, e.g. from
    models/convert.py) or are made by `init_params` from `seed` on
    `device` (CUDA unless the caller asks for the CPU).  The layer
    matrices are cast to `cfg.dtype` once (decoding.serving_params).
    With `adapters={model_id: spec}` one engine serves many LoRA
    variants: a request's model id is the multiplexed id of the calling
    context (`serve.multiplex.get_multiplexed_model_id`).
    """

    def __init__(self, cfg_kwargs: Dict[str, Any], num_slots: int = 8,
                 max_len: int = 256, prompt_pad: int = 64,
                 seed: int = 0, params: Any = None,
                 decode_chunk: int = 8,
                 pipeline_depth: int = 2,
                 paged_kv: bool = True,
                 kv_block_size: Optional[int] = None,
                 kv_num_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 adapters: Optional[Dict[str, Any]] = None,
                 max_resident_models: int = 3,
                 max_queue: int = 0,
                 device=None) -> None:
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.models import decoding, transformer
        cfg = transformer.TransformerConfig(**cfg_kwargs)
        if params is None:
            params = transformer.init_params(
                cfg, seed=seed, device=resolve_device(device))
        if paged_kv:
            # The engine casts for serving itself, after any merge.
            self.batcher: ContinuousBatcher = PagedBatcher(
                params, cfg, num_slots=num_slots, max_len=max_len,
                prompt_pad=prompt_pad, decode_chunk=decode_chunk,
                pipeline_depth=pipeline_depth,
                kv_block_size=kv_block_size,
                kv_num_blocks=kv_num_blocks,
                prefix_cache=prefix_cache, adapters=adapters,
                max_resident_models=max_resident_models,
                max_queue=max_queue)
        else:
            if adapters:
                raise ValueError("adapters/multiplexing requires "
                                 "paged_kv=True")
            params = decoding.serving_params(params, cfg)
            self.batcher = ContinuousBatcher(
                params, cfg, num_slots=num_slots, max_len=max_len,
                prompt_pad=prompt_pad, decode_chunk=decode_chunk,
                pipeline_depth=pipeline_depth, max_queue=max_queue)

    @staticmethod
    def _request_model_id() -> str:
        from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id
        return get_multiplexed_model_id()

    async def generate(self, prompt: List[int],
                       max_new: int = 32) -> Dict[str, Any]:
        """Generate up to `max_new` tokens.  Returns the tokens plus a
        TTFT decomposition; with the paged engine the breakdown also
        carries `cache_hit`/`cached_tokens` (a hit skips device prefill
        for the cached prefix)."""
        import asyncio
        route_t0 = time.time()
        req = self.batcher.submit(prompt, max_new,
                                  model_id=self._request_model_id())
        loop = asyncio.get_running_loop()
        finished = await loop.run_in_executor(None, req.done.wait, 300.0)
        if not finished:
            raise TimeoutError("generation timed out after 300s")
        if req.error is not None:
            raise req.error
        return {"tokens": req.tokens, "ttft_s": req.ttft_s,
                "finish_reason": req.finish_reason,
                "cache_hit": req.cache_hit,
                "cached_tokens": req.cached_tokens,
                "ttft_breakdown": {
                    "route_s": max(req._t0 - route_t0, 0.0),
                    "queue_s": req.queue_s,
                    "prefill_s": req.prefill_s,
                    "cache_hit": req.cache_hit,
                }}

    def generate_stream(self, prompt: List[int],
                        max_new: int = 32) -> Iterator[int]:
        """Streaming generator over the decoded tokens; honours the
        multiplexed model id like generate()."""
        yield from self.batcher.generate_stream(
            prompt, max_new, model_id=self._request_model_id())

    def __call__(self, prompt: List[int]) -> Dict[str, Any]:
        return self.batcher.generate(
            prompt, model_id=self._request_model_id())

    def stats(self) -> Dict[str, Any]:
        out = {"steps": self.batcher.steps}
        if isinstance(self.batcher, PagedBatcher):
            out.update(self.batcher.kv_stats())
        return out

    def stop(self) -> None:
        self.batcher.stop()
