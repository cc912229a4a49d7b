"""Pallas kernel (Triton route): sequential ROLZ resolve (tokens -> bytes).

The zling resolve stage (reference src/libzling_lz.cpp:318-399) is a
byte-granular state machine whose contexts are *decoded content*: the ring
bucket and MTF table a token touches are keyed by the previous output byte,
so the stage is serial within a stream (DESIGN.md section 4).  One program
runs the whole chain: a loop over chunks, and inside it a loop over tokens.

  * the output blocks, the 256 x 4096 ring, the ring heads, the 256 x 256
    sticky-MTF table and the chunk's word-MRU live in device memory (the
    hot parts stay in L1/L2); the two previous output bytes ride in
    registers;
  * a match copy is one masked 512-lane gather from the already written
    bytes and one masked store: ``out[opos + k] = out[src + k % delta]``
    equals the reference's forward, overlapping byte copy
    (src/libzling_lz.cpp:91-104);
  * state lifetimes are the reference's: ring and heads reset at every
    block start, the word-MRU at every chunk, the MTF table lives for the
    whole stream and is carried in and out (``mtf0`` / the returned table),
    so a stream can be resolved in block-granular calls.

Corrupt streams (a symbol outside alphabet 1, match index 0, never-written
ring slots, forward offsets, a match index past the chunk's tokens, output
past encpos) set the chunk's bad flag, strictly stronger than the reference
(SURVEY.md section 9.10).

Oracle: ``spec.decode`` (tests/test_rolz_ops.py, tests/test_device_backend.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import route
from ..tables import (BUCKET_ITEM_SIZE, HUFFMAN_CODES_1, MATCH_MIN_LEN,
                      MTF_INIT, MTF_NEXT)

OUT_SLACK = 1024   # bytes after each block: match overshoot + copy window
_COPY = 512        # match-copy lanes (>= MATCH_MAX_LEN, a power of two)
_RING = 256 * BUCKET_ITEM_SIZE


def _resolve_kernel(tok_ref, cmeta_ref, nxt_ref, _mtf_in, _ring_in,
                    _head_in, _mru_in, out_ref, status_ref, mtf_ref,
                    ring_ref, head_ref, mru_ref, *, interpret: bool):
    n_chunks = cmeta_ref.shape[0]
    lanes = jax.lax.broadcasted_iota(jnp.int32, (_COPY,), 0)

    def ring_insert(ctx, opos):
        h = (head_ref[ctx] + 1) & (BUCKET_ITEM_SIZE - 1)
        head_ref[ctx] = h
        ring_ref[ctx * BUCKET_ITEM_SIZE + h] = opos
        return h

    def mru_push(cu, wu):
        mru_ref[cu * 2 + 1] = mru_ref[cu * 2]
        mru_ref[cu * 2] = wu

    def chunk(c, carry):
        opos_prev, l1, l2, any_bad = carry
        rlen = cmeta_ref[c, 0]
        encpos = cmeta_ref[c, 1]
        new_block = cmeta_ref[c, 2] != 0
        base = cmeta_ref[c, 3]

        @pl.when(new_block)
        def _():
            zero = jnp.zeros((1024,), jnp.int32)

            def zring(i, carry):
                ring_ref[pl.ds(i * 1024, 1024)] = zero
                return carry

            jax.lax.fori_loop(0, _RING // 1024, zring, jnp.int32(0))
            head_ref[pl.ds(0, 256)] = jnp.zeros((256,), jnp.int32)

        mru_ref[pl.ds(0, 512)] = jnp.zeros((512,), jnp.int32)
        route.barrier(interpret)
        opos0 = jnp.where(new_block, 0, opos_prev)

        def head_case(tpos, opos, l1, l2, t, bad):
            out_ref[base + opos] = (t & 255).astype(jnp.uint8)
            return tpos + 1, opos + 1, t & 255, l1, bad

        def literal_case(tpos, opos, l1, l2, t, bad):
            ctx = l1
            sym = mtf_ref[ctx * 256 + t]
            j = nxt_ref[t]
            other = mtf_ref[ctx * 256 + j]
            mtf_ref[ctx * 256 + t] = other
            mtf_ref[ctx * 256 + j] = sym
            out_ref[base + opos] = sym.astype(jnp.uint8)
            ring_insert(ctx, opos)
            mru_push(l2, ctx * 256 + sym)
            return tpos + 1, opos + 1, sym, ctx, bad

        def word_case(tpos, opos, l1, l2, t, bad):
            ctx = l1
            w = mru_ref[ctx * 2 + (t - 256)]
            b0 = jax.lax.shift_right_logical(w, 8) & 255
            b1 = w & 255
            out_ref[base + opos] = b0.astype(jnp.uint8)
            out_ref[base + opos + 1] = b1.astype(jnp.uint8)
            ring_insert(ctx, opos)

            @pl.when(t == 257)
            def _():
                mru_push(ctx, b0 * 256 + b1)

            return tpos + 1, opos + 2, b1, b0, bad

        def match_case(tpos, opos, l1, l2, t, bad):
            mlen = t - 258 + MATCH_MIN_LEN
            midx = tok_ref[c, tpos + 1]
            h = ring_insert(l1, opos)
            src = ring_ref[l1 * BUCKET_ITEM_SIZE
                           + ((h - midx) & (BUCKET_ITEM_SIZE - 1))]
            bad = bad | (midx == 0) | (src == 0) | (src >= opos) \
                | (tpos + 1 >= rlen)

            route.barrier(interpret)
            live = (lanes < mlen) & ~bad
            delta = jnp.maximum(opos - src, 1)
            vals = pltriton.load(
                out_ref.at[base + src + jax.lax.rem(lanes, delta)],
                mask=live, other=0).astype(jnp.int32)
            pltriton.store(out_ref.at[pl.ds(base + opos, _COPY)],
                           vals.astype(jnp.uint8), mask=live)
            route.barrier(interpret)

            def tail(n):
                return jnp.sum(jnp.where(lanes == mlen - n, vals, 0))

            cb1, cb2, cb3 = tail(1), tail(2), tail(3)
            wu = cb2 * 256 + cb1

            @pl.when(mru_ref[cb3 * 2] != wu)
            def _():
                mru_push(cb3, wu)

            return tpos + 2, opos + mlen, cb1, cb2, bad

        def reject_case(tpos, opos, l1, l2, t, bad):
            return tpos, opos, l1, l2, bad

        def body(carry):
            tpos, opos, l1, l2, bad = carry
            t = tok_ref[c, tpos]
            i32 = jnp.int32
            # a symbol outside alphabet 1 (tokens the entropy decoder never
            # wrote when it stopped early on a corrupt chunk) must not index
            # the tables: it flags the chunk and touches nothing
            outside = (t < 0) | (t >= HUFFMAN_CODES_1)
            branch = jnp.where(outside, i32(4), jnp.where(
                opos <= 1, i32(0), jnp.where(
                    t < 256, i32(1), jnp.where(t < 258, i32(2), i32(3)))))
            tpos, opos, l1, l2, bad = jax.lax.switch(
                branch, [head_case, literal_case, word_case, match_case,
                         reject_case],
                tpos, opos, l1, l2, t, bad)
            return tpos, opos, l1, l2, bad | outside | (opos > encpos)

        tpos, opos, l1, l2, bad = jax.lax.while_loop(
            lambda cr: (cr[0] < rlen) & ~cr[4], body,
            (jnp.int32(0), opos0, l1, l2, any_bad))
        bad = bad | (opos != encpos)
        status_ref[c, 0] = opos
        status_ref[c, 1] = tpos
        status_ref[c, 2] = bad.astype(jnp.int32)
        return opos, l1, l2, bad

    jax.lax.fori_loop(0, n_chunks, chunk,
                      (jnp.int32(0), jnp.int32(0), jnp.int32(0),
                       jnp.bool_(False)))


@functools.partial(jax.jit, static_argnames=("out_bytes", "interpret"))
def _resolve_call(tokens, cmeta, mtf0, *, out_bytes: int, interpret: bool):
    C = cmeta.shape[0]
    i32 = jnp.int32
    outs = route.pallas_call(
        functools.partial(_resolve_kernel, interpret=interpret),
        interpret=interpret,
        out_shape=(jax.ShapeDtypeStruct((out_bytes,), jnp.uint8),
                   jax.ShapeDtypeStruct((C, 4), i32),
                   jax.ShapeDtypeStruct((256 * 256,), i32),
                   jax.ShapeDtypeStruct((_RING,), i32),
                   jax.ShapeDtypeStruct((256,), i32),
                   jax.ShapeDtypeStruct((512,), i32)),
        input_output_aliases={3: 2, 4: 3, 5: 4, 6: 5},
        name="zling_resolve",
    )(tokens, cmeta, jnp.asarray(np.asarray(MTF_NEXT, np.int32)), mtf0,
      jnp.zeros(_RING, i32), jnp.zeros(256, i32), jnp.zeros(512, i32))
    return outs[0], outs[1], outs[2]


def initial_mtf_state() -> np.ndarray:
    """The initial MTF table, [256 contexts * 256 ranks] i32 rank -> byte."""
    return np.tile(np.asarray(MTF_INIT, np.int32), 256)


def block_layout(block_sizes) -> tuple[np.ndarray, int]:
    """Byte offset of each block in the kernel's output buffer and the
    buffer's size (every block is followed by OUT_SLACK bytes)."""
    sizes = np.asarray(block_sizes, np.int64) + OUT_SLACK
    bases = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    return bases, int(sizes.sum()) + _COPY


def resolve_stream(tokens, rlens, encpos, new_block, out_base, out_bytes: int,
                   *, interpret: bool, mtf0=None):
    """Resolve all chunks of a stream (or of a run of whole blocks).

    tokens: [C, T] i32 device array (entropy-kernel layout, T >= rlen + 2);
    rlens/encpos/new_block/out_base: per-chunk i32 metadata, out_base being
    the byte offset of the chunk's block in the output (``block_layout``).
    mtf0 optionally carries the MTF table from a previous call; the first
    chunk of this call must then start a new block.
    Returns (out [out_bytes] u8, status [C, 4] i32: [:, 0] = output
    position, [:, 1] = tokens consumed, [:, 2] = bad; mtf [65536] i32 exit
    MTF table).
    """
    cmeta = np.stack([np.asarray(v, np.int32) for v in
                      (rlens, encpos, new_block, out_base)], axis=1)
    if mtf0 is None:
        mtf0 = jnp.asarray(initial_mtf_state())
    return _resolve_call(tokens, jnp.asarray(cmeta), mtf0,
                         out_bytes=out_bytes, interpret=interpret)
