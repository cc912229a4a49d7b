"""Block-data-parallel encode over a jax.sharding.Mesh — canonical streams.

The zling format's large-grain parallel axis is the input block: ROLZ bucket
state resets at block boundaries (SURVEY.md section 0.2), so tokenization
shards cleanly over devices.  This module reproduces the *canonical* stream:
``mesh_encode(data, level)`` is byte-identical to ``spec.encode(data,
level)`` at equal geometry — multi-chunk blocks, the adaptive level drop
(reference src/libzling.cpp:261-266), the cross-block MTF carry, and the
cross-block level carry are all replicated.

Structure per group of D blocks (one per device):

  [device] tokenize each block as its chunk sequence (raw literals),
           under an optimistic per-chunk level schedule
  [device] MTF carry: an O(D) ppermute neighbor-handoff chain -- device k
           relabels its literals with the state received from device k-1
           and hands the updated MTF tables to k+1 (one final psum
           broadcasts the group-exit state)
  [host]   exact per-chunk Huffman length tables (native batch build)
  [device] per-chunk canonical codes + bit-pack
  [host]   validate the level schedule against realized chunk ratios;
           re-run the group with the corrected schedule on (rare)
           mispredicts; assemble the container in block order

Host gathers go through ``host_gather`` which uses
``multihost_utils.process_allgather`` under multi-process runs, so the same
code drives one host or several (tests/test_multihost.py runs the
2-process CPU simulation).

Decode does not scale this way for reference-format streams: the resolve
stage's contexts are decoded content and the MTF chain crosses blocks, so
decode parallelism is pipeline-style only (pipeline.py, device.py).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import huffman as hops
from ..ops import mtf as mops
from ..ops import relabel_kernel as rlk
from ..ops import route
from ..ops import tokenize_kernel as tkk
from ..tables import (
    BLOCK_SIZE_HUFFMAN,
    BLOCK_SIZE_IN,
    BLOCK_SIZE_ROLZ,
    HUFFMAN_CODES_1,
    HUFFMAN_CODES_2,
    HUFFMAN_MAX_LEN_1,
    HUFFMAN_MAX_LEN_2,
    LEVEL_PARAMS,
)

AXIS = "blocks"

def make_mesh(devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, (AXIS,))


def shard_put(arr: np.ndarray, mesh: Mesh, spec: P):
    """Place a host array onto the mesh with the given partitioning,
    multi-process safe: each process materializes only its addressable
    shards (the host array is identical on every process)."""
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() > 1:
        return jax.make_array_from_callback(arr.shape, sharding,
                                            lambda idx: arr[idx])
    return jax.device_put(arr, sharding)


def host_gather(x) -> np.ndarray:
    """Fetch a (possibly sharded) device array to the host, multi-process
    safe: under jax.distributed each process only holds addressable shards,
    so a plain np.asarray would fail — process_allgather assembles the
    global array on every host (SURVEY.md section 5)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


@functools.partial(jax.jit, static_argnames=(
    "mesh", "max_tokens", "max_chunks", "chunk_units", "interpret"))
def parallel_encode_step(blocks, ilens, levels, r2s0, s2r0, *, mesh: Mesh,
                         max_tokens: int, max_chunks: int, chunk_units: int,
                         interpret: bool):
    """Stage 1 of canonical block-DP encode: tokenize + MTF carry.

    blocks [D, B] u8 (padded); ilens [D]; levels [D, max_chunks] per-chunk
    schedule; r2s0/s2r0 replicated carried MTF state.  Returns per-chunk
    symbol/index/valid arrays, chunk metadata, and the replicated MTF state
    after the whole group.
    """
    D = mesh.devices.size

    def step(block, ilen, levels, r2s0, s2r0):
        # O(D) ppermute carry chain: at step k only
        # device k holds the true MTF state; it relabels and hands the
        # updated state to its right neighbor.
        me = jax.lax.axis_index(AXIS)
        ring = [(i, (i + 1) % D) for i in range(D)]
        units, stat = tkk.tokenize_block(
            block[0], ilen[0], levels[0], max_tokens, max_chunks=max_chunks,
            chunk_units=chunk_units, interpret=interpret)
        nunits, ntoks, encpos = stat[:max_chunks, 0], stat[:max_chunks, 1], \
            stat[:max_chunks, 2]
        sym, kind, idx, lit_ctx = tkk.unpack_units(units)
        valid = jnp.arange(chunk_units)[None, :] < nunits[:, None]
        is_lit = (valid & (kind == tkk.KIND_LITERAL)).reshape(-1)
        order, raw_s, run_start, run_len, max_run = rlk.sort_literals(
            lit_ctx.reshape(-1), sym.reshape(-1), is_lit)

        def chain(k, carry):
            r2s, s2r, my_ranks = carry
            ranks_k, r2s_k, s2r_k = rlk.relabel_sorted(
                r2s, s2r, raw_s, run_start, run_len, max_run,
                interpret=interpret)
            mine = me == k
            my_ranks = jnp.where(mine, ranks_k, my_ranks)
            r2s = jnp.where(mine, r2s_k, r2s)
            s2r = jnp.where(mine, s2r_k, s2r)
            r2s = jax.lax.ppermute(r2s, AXIS, ring)
            s2r = jax.lax.ppermute(s2r, AXIS, ring)
            return r2s, s2r, my_ranks

        r2s, s2r, ranks_s = jax.lax.fori_loop(
            0, D, chain, (r2s0, s2r0, jnp.zeros_like(raw_s)))
        ranks = rlk.unsort(order, ranks_s, is_lit)
        sym2 = jnp.where(is_lit, ranks, sym.reshape(-1)) \
            .reshape(max_chunks, chunk_units)

        # after D handoffs the group-exit state sits on device 0: broadcast
        r2s = jax.lax.psum(jnp.where(me == 0, r2s, 0), AXIS)
        s2r = jax.lax.psum(jnp.where(me == 0, s2r, 0), AXIS)

        n_chunks = jnp.sum((nunits > 0).astype(jnp.int32))
        return (sym2[None], idx[None], valid[None], nunits[None], ntoks[None],
                encpos[None], n_chunks[None], r2s, s2r)

    return jax.shard_map(
        step, mesh=mesh, check_vma=False,
        in_specs=(P(AXIS, None), P(AXIS), P(AXIS, None), P(), P()),
        out_specs=(P(AXIS, None, None), P(AXIS, None, None),
                   P(AXIS, None, None), P(AXIS, None), P(AXIS, None),
                   P(AXIS, None), P(AXIS), P(), P()),
    )(blocks, ilens, levels, r2s0, s2r0)


@functools.partial(jax.jit, static_argnames=("mesh",))
def parallel_hist_step(sym2, idx, valid, *, mesh: Mesh):
    """Per-chunk symbol histograms, on BUCKETED chunk arrays.

    Runs as its own step (not inside parallel_encode_step) so the chunk
    axis can be sliced to the realized chunk count first: at canonical
    geometry the padded axis is 129 slots while a typical 16 MB text block
    realizes a third of that, and this stage pays per slot."""

    def step(sym2, idx, valid):
        freq1, freq2 = jax.vmap(hops.unit_histograms)(sym2[0], idx[0],
                                                      valid[0])
        return freq1[None], freq2[None]

    return jax.shard_map(
        step, mesh=mesh, check_vma=False,
        in_specs=(P(AXIS, None, None),) * 3,
        out_specs=(P(AXIS, None, None), P(AXIS, None, None)),
    )(sym2, idx, valid)


@functools.partial(jax.jit, static_argnames=("mesh", "out_words",
                                              "compact_words"))
def parallel_pack_step(sym2, idx, valid, len1, len2, *,
                       mesh: Mesh, out_words: int, compact_words: int):
    """Stage 2: per-chunk bit-packing with each chunk's Huffman tables.

    Canonical code assignment happens here, per device, from the host's
    exact length tables, so only the lengths cross to the device.

    The per-chunk word buffers are compacted on device (each chunk's
    payload words packed end to end at cumsum offsets) so the host gather
    moves ~the compressed size instead of C x out_words of padding --
    at canonical 16 MB geometry that is ~19 MB instead of ~270 MB."""

    def step(sym2, idx, valid, len1, len2):
        enc1 = hops.canonical_codes(len1[0], HUFFMAN_MAX_LEN_1)
        enc2 = hops.canonical_codes(len2[0], HUFFMAN_MAX_LEN_2)
        pack = functools.partial(hops.pack_units, out_words=out_words)
        words, bits = jax.vmap(pack)(sym2[0], idx[0], valid[0], len1[0],
                                     enc1, len2[0], enc2)
        nw = (bits + 31) // 32
        offs = jnp.cumsum(nw) - nw

        words = jax.lax.bitcast_convert_type(words, jnp.int32)

        def body(c, buf):
            return jax.lax.dynamic_update_slice(buf, words[c], (offs[c],))

        compact = jax.lax.fori_loop(
            0, words.shape[0], body, jnp.zeros(compact_words, jnp.int32))
        return compact[None], bits[None], offs[None]

    return jax.shard_map(
        step, mesh=mesh, check_vma=False,
        in_specs=(P(AXIS, None, None),) * 5,
        out_specs=(P(AXIS, None), P(AXIS, None), P(AXIS, None)),
    )(sym2, idx, valid, len1, len2)


def _payload_bytes(bits: int) -> int:
    """Compressed payload size for a bit count (ZlingCodebuf drain rule:
    whole 4-byte groups, then whole bytes, src/libzling.cpp:248-257)."""
    return (bits // 32) * 4 + (bits % 32 + 7) // 8


def _host_encode_group(gblocks, gilens, level: int, entry_level: int,
                       r2s: np.ndarray, s2r: np.ndarray, max_tokens: int):
    """Elastic-recovery lane: re-encode ONE group of blocks on the host from
    the carried (MTF, level) snapshot -- identical bytes, since blocks are
    pure functions of (bytes, carried state) (src/libzling.cpp:187-284).

    Returns (stream bytes for the group, r2s', s2r', exit level).
    """
    from .. import spec

    enc = spec.RolzEncoder()
    for c in range(256):
        enc.mtf[c].table = [int(v) for v in r2s[c]]
        enc.mtf[c].index = [int(v) for v in s2r[c]]
    out = bytearray()
    current_level = entry_level
    for blk, ilen in zip(gblocks, gilens):
        if ilen == 0:
            continue
        block = bytearray(blk[:ilen].tobytes())
        block.extend(bytes(spec.SENTINEL_LEN))
        enc.reset()
        encpos = 0
        while encpos < ilen:
            out.append(1)
            encpos_old = encpos
            tokens, encpos = enc.encode_chunk(current_level, block, ilen,
                                              encpos, max_tokens)
            payload = spec.huffman_encode_chunk(tokens)
            olen = len(payload)
            current_level = 0 if olen / (encpos - encpos_old + 1) > 0.95 \
                else level
            out.extend(encpos.to_bytes(4, "big"))
            out.extend(len(tokens).to_bytes(4, "big"))
            out.extend(olen.to_bytes(4, "big"))
            out.extend(payload)
        out.append(0)
    r2s2 = np.asarray([enc.mtf[c].table for c in range(256)], np.int32)
    s2r2 = np.asarray([enc.mtf[c].index for c in range(256)], np.int32)
    return bytes(out), r2s2, s2r2, current_level


def mesh_encode(data: bytes, level: int, mesh: Mesh | None = None,
                block_size: int = BLOCK_SIZE_IN,
                max_tokens: int = BLOCK_SIZE_ROLZ,
                elastic: bool = False) -> bytes:
    """Encode with blocks sharded over the mesh; byte-identical to
    ``spec.encode(data, level, block_size=block_size, max_tokens=max_tokens)``
    (canonical reference stream at default geometry).

    elastic=True adds block-group-granular recovery: if the device path
    fails mid-stream (lost chip, wedged runtime), only the FAILED group is
    re-encoded on the host from its carried (MTF, level) snapshot -- all
    completed groups' device work is kept, and the stream is unchanged.
    """
    if level not in LEVEL_PARAMS:
        raise ValueError("level must be 0..6")
    if not data:
        return b""
    if mesh is None:
        mesh = make_mesh()
    interpret = route.interpret_mode(mesh.devices.flat[0])
    route.init_compile_cache()
    D = mesh.devices.size
    # a unit consumes >= 1 input byte, so units/chunk <= min(cap, block)
    chunk_units = min(max_tokens, block_size + 8)
    max_chunks = max(1, -(-block_size // max(1, max_tokens // 2))) + 1
    out_words = min(BLOCK_SIZE_HUFFMAN // 4, chunk_units * 2) + 16
    pad = tkk.BLOCK_PAD

    header = (HUFFMAN_CODES_1 + HUFFMAN_CODES_2) // 2
    nblocks = (len(data) + block_size - 1) // block_size
    out = bytearray()
    r2s, s2r = mops.initial_state()
    current_level = level

    kw = dict(mesh=mesh, max_tokens=max_tokens, max_chunks=max_chunks,
              chunk_units=chunk_units, interpret=interpret)

    def dispatch(group: int, entry_level: int, r2s_in, s2r_in) -> dict:
        gblocks, gilens = [], []
        for d in range(D):
            blk = data[(group + d) * block_size: (group + d + 1) * block_size]
            gilens.append(len(blk))
            gblocks.append(np.frombuffer(
                blk + bytes(block_size + pad - len(blk)), np.uint8))
        blocks = shard_put(np.stack(gblocks), mesh, P(AXIS, None))
        ilens = shard_put(np.asarray(gilens, np.int32), mesh, P(AXIS))
        # optimistic schedule: requested level everywhere except the
        # carried entry chunk
        sched = np.full((D, max_chunks), level, np.int32)
        sched[0, 0] = entry_level
        outs = exc = None
        try:
            outs = parallel_encode_step(blocks, ilens,
                                        shard_put(sched, mesh, P(AXIS, None)),
                                        r2s_in, s2r_in, **kw)
        except Exception as e:  # surfaces when this group is consumed
            exc = e
        return dict(group=group, blocks=blocks, ilens=ilens, gblocks=gblocks,
                    gilens=gilens, sched=sched, entry=entry_level,
                    r2s_in=r2s_in, s2r_in=s2r_in, outs=outs, exc=exc)

    # 1-deep pipeline: group g+1's tokenize step is DISPATCHED (async)
    # before group g's host stages run, chaining the MTF state through
    # device-resident arrays -- the device chews g+1 while the host gathers
    # histograms, builds length tables, and frames g.  The lookahead
    # predicts g's exit level == the requested level (the adaptive drop is
    # rare); a mispredict or an in-group schedule fix invalidates the
    # lookahead's inputs and re-dispatches it (counted in metrics).
    pend = dispatch(0, current_level, r2s, s2r)
    for group in range(0, nblocks, D):
        cur = pend
        nxt = group + D
        pend = dispatch(nxt, level, cur["outs"][-2], cur["outs"][-1]) \
            if nxt < nblocks and cur["outs"] is not None else None
        try:
            if cur["outs"] is None:
                raise cur["exc"]
            out_g, expected, r2s, s2r, clean = _finish_group_device(
                cur, group, nblocks, level, out_words=out_words,
                header=header, **kw)
        except Exception:
            if not elastic:
                raise
            from ..utils import metrics

            metrics.registry.count("enc.group_failover")
            out_g, r2s_np, s2r_np, expected = _host_encode_group(
                cur["gblocks"], cur["gilens"], level, cur["entry"],
                host_gather(cur["r2s_in"]), host_gather(cur["s2r_in"]),
                max_tokens)
            r2s, s2r = jnp.asarray(r2s_np), jnp.asarray(s2r_np)
            clean = False
        out.extend(out_g)
        current_level = expected
        if nxt < nblocks and (pend is None or not clean
                              or expected != level):
            if pend is not None:
                from ..utils import metrics

                metrics.registry.count("enc.pipeline_redispatch")
            pend = dispatch(nxt, expected, r2s, s2r)
    return bytes(out)


def _finish_group_device(cur: dict, group, nblocks, level, *, mesh,
                         max_tokens, max_chunks, chunk_units, interpret,
                         out_words, header):
    """Host/device tail of one block group whose tokenize step was already
    dispatched (tables + pack + schedule validation + framing).  Returns
    (group bytes, exit level, carried r2s, s2r, clean) where clean=False
    means the group's tokenize was re-run (schedule fix) and any lookahead
    chained from the original outputs is invalid."""
    D = mesh.devices.size
    sched, gilens = cur["sched"], cur["gilens"]
    current_level = cur["entry"]
    outs = cur["outs"]
    passes = 0
    while True:
        passes += 1
        (sym2, idx, valid, nunits, ntoks, encpos, n_chunks,
         r2s_new, s2r_new) = outs
        nchunks_np = host_gather(n_chunks)
        # BUCKET the chunk axis to the realized count (rounded up to 8 for
        # executable reuse): the padded axis is sized for the all-literal
        # worst case (129 slots at canonical geometry) while typical blocks
        # realize a third of that, and the histogram/pack stages pay per
        # slot
        bucket = min(max_chunks,
                     max(8, -(-int(np.max(nchunks_np)) // 8) * 8))
        sym2b, idxb, validb = (sym2[:, :bucket], idx[:, :bucket],
                               valid[:, :bucket])
        freq1, freq2 = parallel_hist_step(sym2b, idxb, validb, mesh=mesh)
        f1 = host_gather(freq1).reshape(D * bucket, HUFFMAN_CODES_1)
        f2 = host_gather(freq2).reshape(D * bucket, HUFFMAN_CODES_2)
        len1 = hops.exact_length_tables(f1, HUFFMAN_MAX_LEN_1) \
            .reshape(D, bucket, HUFFMAN_CODES_1)
        len2 = hops.exact_length_tables(f2, HUFFMAN_MAX_LEN_2) \
            .reshape(D, bucket, HUFFMAN_CODES_2)
        # a unit packs to < 4 bytes and consumes >= 1 input byte, so a
        # block's payload words are bounded by its byte count; the compact
        # buffer is HBM-cheap, and the host gather below moves only the
        # realized compressed words
        compact_words = int(np.max(gilens)) + out_words + 64
        words, bits, offs = parallel_pack_step(
            sym2b, idxb, validb,
            shard_put(len1, mesh, P(AXIS, None, None)),
            shard_put(len2, mesh, P(AXIS, None, None)),
            mesh=mesh, out_words=out_words, compact_words=compact_words)
        bits_np = host_gather(bits)
        encpos_np = host_gather(encpos)

        # serial schedule validation (the adaptive drop couples chunk
        # k+1 to chunk k across block boundaries, libzling.cpp:261-266).
        # The first mismatch is fixed exactly (its prefix is valid, so
        # its tokens are final); later chunks are re-predicted from the
        # realized ratios as an approximation and re-validated on the
        # next pass — converges because the true first-mismatch position
        # advances strictly each iteration, and typically in <= 2 passes.
        expected = current_level
        any_fix = False
        for d in range(D):
            if group + d >= nblocks or gilens[d] == 0:
                continue
            prev_end = 0
            for c in range(int(nchunks_np[d])):
                if int(sched[d, c]) != expected:
                    sched[d, c] = expected
                    any_fix = True
                ep = int(encpos_np[d, c])
                olen = header + _payload_bytes(int(bits_np[d, c]))
                expected = 0 if olen / (ep - prev_end + 1) > 0.95 else level
                prev_end = ep
            # chunk boundaries may shift after fixes: predict the tail
            sched[d, int(nchunks_np[d]):] = expected
        if not any_fix:
            break
        # corrected schedule: re-run this group's tokenize from the same
        # carried state (the lookahead chained off the old outputs is now
        # stale -- the caller re-dispatches it on clean=False)
        outs = parallel_encode_step(
            cur["blocks"], cur["ilens"],
            shard_put(sched, mesh, P(AXIS, None)),
            cur["r2s_in"], cur["s2r_in"], mesh=mesh, max_tokens=max_tokens,
            max_chunks=max_chunks, chunk_units=chunk_units,
            interpret=interpret)

    if passes > 1:
        from ..utils import metrics

        metrics.registry.count("enc.schedule_mispredicts", passes - 1)

    # ---- host: ordered gather + container framing (fetch only the
    # realized compressed words, not the padded pack buffers)
    out = bytearray()
    offs_np = host_gather(offs)
    nw_np = (bits_np + 31) // 32
    needed = int(np.max(offs_np + nw_np)) if offs_np.size else 0
    words_np = host_gather(words[:, :max(needed, 1)])
    ntoks_np = host_gather(ntoks)
    for d in range(D):
        if group + d >= nblocks or gilens[d] == 0:
            continue
        for c in range(int(nchunks_np[d])):
            o = int(offs_np[d, c])
            w = words_np[d, o: o + int(nw_np[d, c])]
            payload = hops.payload_from_words(
                w, int(bits_np[d, c]), len1[d, c], len2[d, c])
            out.append(1)
            out.extend(int(encpos_np[d, c]).to_bytes(4, "big"))
            out.extend(int(ntoks_np[d, c]).to_bytes(4, "big"))
            out.extend(len(payload).to_bytes(4, "big"))
            out.extend(payload)
        out.append(0)
    return bytes(out), expected, r2s_new, s2r_new, passes == 1
