"""Block-parallel host pipeline over the split-stage native engine.

The format's only large-grain parallel axis is the 16 MB block (SURVEY.md
section 2): ROLZ bucket state resets per block, so tokenization is
block-independent -- provided literals are emitted raw, because the MTF
tables are the one piece of state that crosses blocks.  This module runs the
codec as the three-phase pipeline of SURVEY.md section 7.0:

  encode:  [parallel] tokenize blocks (raw literals)
           [serial]   MTF relabel carry pass  (cheap: one table op per literal)
           [parallel] per-chunk entropy coding
  decode:  [parallel] per-chunk entropy decode
           [serial]   ROLZ resolve + inverse MTF (content-dependent contexts
                      make this stage inherently serial for zling streams)

The adaptive level drop (src/libzling.cpp:261-266) couples chunk k+1's
tokenization to chunk k's compressed size.  Tokenization runs optimistically
with a predicted level schedule; the serial phase validates predictions and
re-tokenizes a block with the corrected schedule on the (rare) mispredict.
Output is bit-exact with the reference encoder.
"""

from __future__ import annotations

import ctypes
import itertools
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from .native import engine as native
from .tables import BLOCK_SIZE_IN, BLOCK_SIZE_HUFFMAN, BLOCK_SIZE_ROLZ, SENTINEL_LEN
from .utils import metrics

_MAX_CHUNKS = 192           # >= ceil(16MB / 131072) worst-case chunks per block
# worst case one token per input byte, plus one chunk of 2-token slack
_MAX_BLOCK_TOKENS = BLOCK_SIZE_IN + BLOCK_SIZE_ROLZ + 16


def _bind(dll):
    if getattr(dll, "_zlt_pipeline_ready", False):
        return
    dll.zlt_tokenizer_new.restype = ctypes.c_void_p
    dll.zlt_tokenizer_free.argtypes = [ctypes.c_void_p]
    dll.zlt_tokenize_block_raw.restype = ctypes.c_int
    dll.zlt_tokenize_block_raw.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    dll.zlt_mtf_new.restype = ctypes.c_void_p
    dll.zlt_mtf_free.argtypes = [ctypes.c_void_p]
    dll.zlt_mtf_reset.argtypes = [ctypes.c_void_p]
    dll.zlt_relabel_block.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    dll.zlt_mtf_save.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dll.zlt_mtf_load.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dll.zlt_entropy_encode.restype = ctypes.c_int
    dll.zlt_entropy_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    dll.zlt_entropy_decode.restype = ctypes.c_int
    dll.zlt_entropy_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    dll.zlt_resolver_new.restype = ctypes.c_void_p
    dll.zlt_resolver_free.argtypes = [ctypes.c_void_p]
    dll.zlt_resolver_reset_stream.argtypes = [ctypes.c_void_p]
    dll.zlt_resolver_mtf_save.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dll.zlt_resolver_mtf_load.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dll.zlt_resolver_reset_block.argtypes = [ctypes.c_void_p]
    dll.zlt_resolve_chunk.restype = ctypes.c_int
    dll.zlt_resolve_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
    ]
    dll.zlt_counters.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dll.zlt_counters_reset.argtypes = [ctypes.c_void_p]
    dll._zlt_pipeline_ready = True


class _PrioPool:
    """Fixed thread pool draining a priority queue (lower number = sooner).

    All parallel CPU work (block tokenization AND per-chunk entropy coding)
    flows through these threads, sized to the core count, so the machine is
    never oversubscribed: the main thread only does the serial MTF relabel
    and container assembly.  Entropy jobs run at higher priority than
    tokenize jobs because the main thread blocks on their results next,
    while tokenize results are needed one block later.
    """

    def __init__(self, nthreads: int, name: str):
        self.q: queue.PriorityQueue = queue.PriorityQueue()
        self._seq = itertools.count()
        self.threads = [
            threading.Thread(target=self._run, daemon=True, name=f"{name}-{i}")
            for i in range(nthreads)
        ]
        for t in self.threads:
            t.start()

    def submit(self, prio: int, fn, *args) -> Future:
        fut: Future = Future()
        self.q.put((prio, next(self._seq), fn, args, fut))
        return fut

    @staticmethod
    def _exec(item):
        _prio, _seq, fn, args, fut = item
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(fn(*args))
        except BaseException as exc:  # noqa: BLE001 - relayed via future
            fut.set_exception(exc)

    def _run(self):
        while True:
            item = self.q.get()
            if item[2] is None:
                return
            self._exec(item)

    def result_helping(self, fut: Future, max_help_prio: int):
        """Wait for ``fut``, executing queued short jobs (prio <= threshold)
        on the calling thread in the meantime.

        The workers have no preemption: a queued high-priority entropy job
        can sit behind two in-flight 200-600 ms tokenize jobs.  Letting the
        blocked main thread drain such jobs keeps both cores on tokenize
        while the (otherwise idle) main thread absorbs the entropy stage.
        """
        while not fut.done():
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                break
            if item[0] > max_help_prio:
                self.q.put(item)  # long job: leave it for a worker
                break
            self._exec(item)
        return fut.result()

    def shutdown(self):
        for _ in self.threads:
            self.q.put((1 << 30, next(self._seq), None, (), None))


class _TokenizerPool:
    """Per-thread native tokenizer contexts plus a shared token-buffer pool.

    Buffers are recycled through an explicit free queue (ownership passes
    from worker to consumer and back): freshly-mapped pages fault at
    ~0.2 GB/s on virtualized hosts, so reusing warm 34 MB token buffers
    matters more than the tokenizer work itself for short calls.
    """

    def __init__(self, dll, nbuffers: int):
        self.dll = dll
        self.local = threading.local()
        self.free: queue.Queue = queue.Queue()
        self.handles: list[int] = []  # all per-thread engines, for counters
        for _ in range(nbuffers):
            self.free.put(np.empty(_MAX_BLOCK_TOKENS, np.uint16))

    def handle(self):
        h = getattr(self.local, "h", None)
        if h is None:
            h = self.dll.zlt_tokenizer_new()
            self.local.h = h
            self.handles.append(h)
        return h

    def take_buffer(self):
        return self.free.get()

    def give_back(self, buf):
        self.free.put(buf)


_PRIO_ENTROPY = 0
_PRIO_TOKENIZE = 1


class ParallelEncoder:
    def __init__(self, workers: int = 2):
        self.dll = native._lib()
        _bind(self.dll)
        self.workers = workers
        self.pool = _PrioPool(workers, name="zlt-enc")
        self.tok = _TokenizerPool(self.dll, nbuffers=workers + 2)
        self.mtf = self.dll.zlt_mtf_new()
        self._out = None
        # recycled per-chunk entropy scratch buffers; grown on demand (a
        # typical 16 MB block has ~10-25 chunks in flight, pathological
        # all-literal blocks up to 64)
        self.ent_free: queue.Queue = queue.Queue()

    def _take_scratch(self):
        try:
            return self.ent_free.get_nowait()
        except queue.Empty:
            return np.empty(BLOCK_SIZE_HUFFMAN + 64, np.uint8)

    def _entropy_chunk(self, tokens, tpos: int, rlen: int, scratch) -> int:
        return self.dll.zlt_entropy_encode(
            tokens.ctypes.data + 2 * tpos, rlen, scratch.ctypes.data)

    def _tokenize_block(self, block_view, ilen, levels):
        tokens = self.tok.take_buffer()
        rlens = np.zeros(_MAX_CHUNKS, np.int32)
        encpos = np.zeros(_MAX_CHUNKS, np.int32)
        lv = np.ascontiguousarray(levels, np.int32)
        n = self.dll.zlt_tokenize_block_raw(
            self.tok.handle(), block_view.ctypes.data, ilen, lv.ctypes.data,
            _MAX_CHUNKS, tokens.ctypes.data, _MAX_BLOCK_TOKENS,
            rlens.ctypes.data, encpos.ctypes.data)
        if n < 0:
            self.tok.give_back(tokens)
            raise RuntimeError("tokenize overflow")
        return tokens, rlens[:n], encpos[:n], lv

    def encode(self, data: bytes, level: int) -> bytes:
        out, _carry = self.encode_with_carry(data, level, carry=None)
        return out

    def encode_with_carry(self, data: bytes, level: int,
                          carry: tuple[bytes, int] | None) -> tuple[bytes, tuple[bytes, int]]:
        """Encode whole 16 MB blocks with explicit cross-call state.

        carry is (mtf_state_bytes, current_level) from a previous call (or
        None for stream start); the data of every call except the last MUST
        be a multiple of BLOCK_SIZE_IN -- shorter pieces end an input_block
        early, which still yields a valid stream but not the one-shot bytes.
        This is the block-granular checkpoint/resume seam: the format is
        resumable at block boundaries given the 128 KB MTF state
        (SURVEY.md section 5).
        """
        if not 0 <= level <= 6:
            raise ValueError("level must be 0..6")
        if not data:
            state = carry if carry is not None else (self.mtf_state_bytes(reset=True), level)
            return b"", state
        buf = np.frombuffer(data, np.uint8)
        nblocks = (len(data) + BLOCK_SIZE_IN - 1) // BLOCK_SIZE_IN
        views = [
            buf[b * BLOCK_SIZE_IN: min((b + 1) * BLOCK_SIZE_IN, len(data))]
            for b in range(nblocks)
        ]
        # optimistic schedule: every chunk at the requested level
        predicted = [np.full(_MAX_CHUNKS, level, np.int32) for _ in range(nblocks)]

        # no retry wrapper: _tokenize_block is a pure function of
        # (bytes, schedule), so its only failure ("tokenize overflow") is
        # deterministic and retrying could only double the cost of a real bug
        futures = [
            self.pool.submit(_PRIO_TOKENIZE, self._tokenize_block, v, len(v), predicted[b])
            for b, v in enumerate(views)
        ]

        if carry is None:
            self.dll.zlt_mtf_reset(self.mtf)
            current_level = level
        else:
            self.load_mtf_state(carry[0])
            current_level = carry[1]
        snapshot = np.empty(2 * 256 * 256, np.uint8)
        cap = native._lib().zlt_encode_bound(len(data))
        if self._out is None or self._out.size < cap:
            self._out = np.empty(cap, np.uint8)
        out = self._out
        opos = 0

        consumed = 0
        tokens = None
        try:
            for b in range(nblocks):
                tokens, rlens, encpos, used_levels = self.pool.result_helping(
                    futures[b], _PRIO_ENTROPY)
                consumed += 1
                view = views[b]
                self.dll.zlt_mtf_save(self.mtf, snapshot.ctypes.data)
                while True:
                    # serial carry pass: raw literals -> MTF ranks (in place)
                    rl_arr = np.ascontiguousarray(rlens, np.int32)
                    self.dll.zlt_relabel_block(
                        self.mtf, view.ctypes.data, tokens.ctypes.data,
                        rl_arr.ctypes.data, len(rl_arr))
                    # entropy coding fans out to the worker pool (chunks are
                    # independent once relabeled); the adaptive-level
                    # validation below only needs each chunk's olen, which is
                    # a pure function of its tokens
                    jobs = []
                    tpos = 0
                    for c in range(len(rl_arr)):
                        scratch = self._take_scratch()
                        fut = self.pool.submit(
                            _PRIO_ENTROPY, self._entropy_chunk,
                            tokens, tpos, int(rl_arr[c]), scratch)
                        jobs.append((fut, scratch))
                        tpos += int(rl_arr[c])
                    lvl = current_level
                    mispredict_at = -1
                    prev_end = 0
                    opos_block = opos
                    for c, (fut, scratch) in enumerate(jobs):
                        if mispredict_at >= 0 or used_levels[c] != lvl:
                            if mispredict_at < 0:
                                mispredict_at = c
                            # drain: the task still reads the token buffer
                            self.pool.result_helping(fut, _PRIO_ENTROPY)
                            self.ent_free.put(scratch)
                            continue
                        olen = self.pool.result_helping(fut, _PRIO_ENTROPY)
                        ep, rl = int(encpos[c]), int(rl_arr[c])
                        out[opos] = 1
                        hdr = ep.to_bytes(4, "big") + rl.to_bytes(4, "big") \
                            + olen.to_bytes(4, "big")
                        out[opos + 1: opos + 13] = np.frombuffer(hdr, np.uint8)
                        out[opos + 13: opos + 13 + olen] = scratch[:olen]
                        self.ent_free.put(scratch)
                        opos += 13 + olen
                        lvl = 0 if olen / (ep - prev_end + 1) > 0.95 else level
                        if lvl == 0 and level != 0:
                            metrics.registry.count("enc.level_drops")
                        prev_end = ep
                    if mispredict_at < 0:
                        current_level = lvl
                        break
                    opos = opos_block
                    metrics.registry.count("enc.schedule_mispredicts")
                    # mispredicted: rebuild the schedule (validated prefix +
                    # the corrected level) and re-tokenize this block serially
                    sched = np.full(_MAX_CHUNKS, level, np.int32)
                    sched[:mispredict_at] = used_levels[:mispredict_at]
                    sched[mispredict_at] = lvl
                    if lvl == 0:
                        sched[mispredict_at:] = 0  # incompressible runs stay dropped
                    self.dll.zlt_mtf_load(self.mtf, snapshot.ctypes.data)
                    self.tok.give_back(tokens)
                    tokens, rlens, encpos, used_levels = self._tokenize_block(
                        view, len(view), sched)
                out[opos] = 0
                opos += 1
                # always-firing registry counters: prove the metrics wiring
                # is live in every bench artifact (drops/mispredicts only
                # fire on mixed-compressibility inputs)
                metrics.registry.count("enc.blocks")
                metrics.registry.count("enc.chunks", len(rl_arr))
                self.tok.give_back(tokens)
                tokens = None
        finally:
            # on error, give back the in-flight buffer and those of
            # unconsumed futures so the pool never drains permanently
            if tokens is not None:
                self.tok.give_back(tokens)
            for fut in futures[consumed:]:
                try:
                    self.tok.give_back(fut.result()[0])
                except Exception:
                    pass
        return out[:opos].tobytes(), (self.mtf_state_bytes(), current_level)

    _COUNTER_NAMES = ("bucket_updates", "chain_steps", "match_succ",
                      "match_fail", "lazy_skips", "word_hits", "literals",
                      "match_bytes")

    def counters(self) -> dict[str, int]:
        """Aggregate match-loop counters from every tokenizer thread
        (reference debug-counter analog, src/libzling_lz.cpp:226-287)."""
        buf = np.zeros(8, np.uint64)
        total = np.zeros(8, np.uint64)
        for h in self.tok.handles:
            self.dll.zlt_counters(h, buf.ctypes.data)
            total += buf
        return dict(zip(self._COUNTER_NAMES, (int(v) for v in total)))

    def mtf_state_bytes(self, reset: bool = False) -> bytes:
        if reset:
            self.dll.zlt_mtf_reset(self.mtf)
        buf = np.empty(2 * 256 * 256, np.uint8)
        self.dll.zlt_mtf_save(self.mtf, buf.ctypes.data)
        return buf.tobytes()

    def load_mtf_state(self, state: bytes) -> None:
        buf = np.frombuffer(state, np.uint8)
        self.dll.zlt_mtf_load(self.mtf, buf.ctypes.data)


class ParallelDecoder:
    def __init__(self, workers: int = 2):
        self.dll = native._lib()
        _bind(self.dll)
        self.workers = workers
        self.pool = ThreadPoolExecutor(workers, thread_name_prefix="zlt-ent")
        self.resolver = self.dll.zlt_resolver_new()
        self._out = None
        self._in = None
        self.tok_free: queue.Queue = queue.Queue()
        for _ in range(workers + 2):
            self.tok_free.put(np.empty(BLOCK_SIZE_ROLZ + 16, np.uint16))

    def _entropy_chunk(self, in_arr, off, olen, rlen):
        tokens = self.tok_free.get()
        rc = self.dll.zlt_entropy_decode(
            in_arr.ctypes.data + off, olen, rlen, tokens.ctypes.data)
        if rc != 0:
            self.tok_free.put(tokens)
            raise ValueError("zling: corrupt stream (entropy)")
        return tokens

    def decode(self, data: bytes) -> bytes:
        out, _carry = self.decode_with_carry(data, carry=None)
        return out

    def decode_with_carry(self, data: bytes, carry: bytes | None) -> tuple[bytes, bytes]:
        """Decode whole blocks with explicit MTF state for resume.

        carry is the 128 KB decode-side MTF state from a previous call (None
        for stream start); ``data`` must contain whole input_blocks.
        """
        if not data:
            if carry is None:
                self.dll.zlt_resolver_reset_stream(self.resolver)
            else:
                self._load_mtf(carry)
            return b"", self._save_mtf()
        # one padded copy of the stream so the word-wise bit reader can
        # over-read up to 8 bytes past any payload (reused, grow-only)
        n = len(data)
        if self._in is None or self._in.size < n + 8:
            self._in = np.empty(n + 8, np.uint8)
        in_arr = self._in
        in_arr[:n] = np.frombuffer(data, np.uint8)
        in_arr[n:n + 8] = 0
        # parse container framing
        chunks = []  # (block_id, encpos, rlen, payload_offset, olen)
        pos = 0
        block_id = 0
        block_sizes = []
        last_encpos = 0
        while pos < n:
            flag = data[pos]
            pos += 1
            if flag == 0:
                block_sizes.append(last_encpos)
                last_encpos = 0
                block_id += 1
                continue
            if flag != 1 or pos + 12 > n:
                raise ValueError("zling: corrupt stream (bad framing)")
            encpos = int.from_bytes(data[pos:pos + 4], "big")
            rlen = int.from_bytes(data[pos + 4:pos + 8], "big")
            olen = int.from_bytes(data[pos + 8:pos + 12], "big")
            pos += 12
            # encpos must be non-decreasing within a block: the output region
            # is sized by the block's LAST chunk, so a decreasing sequence
            # would let an earlier chunk write past it
            if (rlen > BLOCK_SIZE_ROLZ or olen > BLOCK_SIZE_HUFFMAN
                    or encpos > BLOCK_SIZE_IN or encpos < last_encpos
                    or pos + olen > n):
                raise ValueError("zling: corrupt stream (bad chunk header)")
            chunks.append((block_id, encpos, rlen, pos, olen))
            last_encpos = encpos
            pos += olen
        if last_encpos != 0:
            raise ValueError("zling: truncated stream (missing stop flag)")
        metrics.registry.count("dec.blocks", len(block_sizes))
        metrics.registry.count("dec.chunks", len(chunks))

        total = sum(block_sizes)
        if self._out is None or self._out.size < total + SENTINEL_LEN:
            self._out = np.empty(total + SENTINEL_LEN, np.uint8)
        out = self._out
        block_base = np.cumsum([0] + block_sizes[:-1]) if block_sizes else []

        futures = [self.pool.submit(self._entropy_chunk, in_arr, off, olen, rlen)
                   for (_b, _e, rlen, off, olen) in chunks]

        if carry is None:
            self.dll.zlt_resolver_reset_stream(self.resolver)
        else:
            self._load_mtf(carry)
        cur_block = -1
        opos = 0
        consumed = 0
        try:
            for (bid, encpos, rlen, _off, _ol), fut in zip(chunks, futures):
                tokens = fut.result()
                consumed += 1
                if bid != cur_block:
                    self.dll.zlt_resolver_reset_block(self.resolver)
                    cur_block = bid
                    opos = 0
                base = int(block_base[bid])
                opos = self.dll.zlt_resolve_chunk(
                    self.resolver, tokens.ctypes.data, rlen, encpos,
                    out.ctypes.data + base, opos)
                self.tok_free.put(tokens)
                if opos < 0:
                    raise ValueError("zling: corrupt stream (resolve)")
        finally:
            # on error, drain unconsumed futures so their pooled buffers come
            # back -- a leaked buffer would hang every later decode
            for fut in futures[consumed:]:
                try:
                    self.tok_free.put(fut.result())
                except ValueError:
                    pass
        return out[:total].tobytes(), self._save_mtf()

    def _save_mtf(self) -> bytes:
        buf = np.empty(2 * 256 * 256, np.uint8)
        self.dll.zlt_resolver_mtf_save(self.resolver, buf.ctypes.data)
        return buf.tobytes()

    def _load_mtf(self, state: bytes) -> None:
        buf = np.frombuffer(state, np.uint8)
        self.dll.zlt_resolver_mtf_load(self.resolver, buf.ctypes.data)


_ENC: ParallelEncoder | None = None
_DEC: ParallelDecoder | None = None
# the singletons are stateful (shared MTF handles, shared scratch buffers),
# so whole calls are serialized; internal 2-thread parallelism is unaffected
_ENC_LOCK = threading.Lock()
_DEC_LOCK = threading.Lock()


def encode(data: bytes, level: int = 0) -> bytes:
    global _ENC
    with _ENC_LOCK:
        if _ENC is None:
            _ENC = ParallelEncoder()
        return _ENC.encode(bytes(data), level)


def decode(data: bytes) -> bytes:
    global _DEC
    with _DEC_LOCK:
        if _DEC is None:
            _DEC = ParallelDecoder()
        return _DEC.decode(bytes(data))


def counters() -> dict[str, int]:
    """Match-loop counters of the module-level encoder plus the host
    metrics registry (level drops, schedule mispredicts)."""
    out: dict[str, int] = {}
    with _ENC_LOCK:
        if _ENC is not None:
            out.update(_ENC.counters())
    out.update(metrics.registry.snapshot()["counters"])
    return out
