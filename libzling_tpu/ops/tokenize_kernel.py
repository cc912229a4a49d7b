"""Pallas kernel (Triton route): ROLZ tokenizer (block bytes -> units).

The encoder hot loop (reference MatchAndUpdate / MatchLazy / EncodeImpl,
src/libzling_lz.cpp:139-316) as one program per 16 MB input block: the
program runs the block's whole chunk sequence under a per-chunk level
schedule and emits one unit per alphabet-1 symbol (a match carries its
ring index beside it; literal units carry RAW bytes, because the MTF
relabel is a separate pass, ops/relabel_kernel.py).

  * the block bytes, the hash heads (256 x 8192), the chain and slot rings
    (256 x 4096) and the ring heads live in device memory -- about 16 MB
    of tables plus the block, which stays in the 50 MB L2;
  * GetCommonLength (src/libzling_lz.cpp:66-89) is one 512-lane vector
    compare of the two windows and a min-reduction to the first mismatch;
  * chain walks and lazy probes are while loops of dynamic depth, so the
    extended levels e5/e6 are exact;
  * the word-MRU resets per chunk and the bucket tables per block, as in
    the reference.

Output: one packed word per unit, ``sym | kind << 10 | aux << 14`` where
aux is the match index for matches and the literal's order-1 context byte
for literals, so the relabel pass needs no side lookup into the block.

Oracle: ``spec.RolzEncoder.encode_chunk`` (tests/test_tokenize_kernel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from . import route
from ..tables import (
    BUCKET_ITEM_HASH,
    BUCKET_ITEM_SIZE,
    LEVEL_PARAMS,
    MATCH_MAX_LEN,
    MATCH_MIN_LEN,
    MATCH_MIN_LEN_ENABLE_LAZY,
)

KIND_RAW, KIND_LITERAL, KIND_WORD, KIND_MATCH = 0, 1, 2, 3
BLOCK_PAD = 1024   # zero bytes the kernel may read past the block's end
_NIL = 65535
_LCP = 512         # common-length window (>= MATCH_MAX_LEN, a power of two)
_RING_MASK = BUCKET_ITEM_SIZE - 1
_LEVEL_TABLE = np.asarray([LEVEL_PARAMS[l] for l in sorted(LEVEL_PARAMS)],
                          np.int32)


def _srl(x, n):
    return jax.lax.shift_right_logical(x, n)


def _tokenize_kernel(kmeta_ref, block_ref, _hash_in, _chain_in, _slot_in,
                     _head_in, _mru_in, units_ref, stat_ref, hash_ref,
                     chain_ref, slot_ref, head_ref, mru_ref, *,
                     max_chunks: int, chunk_units: int, interpret: bool):
    ilen = kmeta_ref[0]
    max_tokens = kmeta_ref[1]
    match_limit = ilen - MATCH_MAX_LEN - 16
    lanes = jax.lax.broadcasted_iota(jnp.int32, (_LCP,), 0)

    def byte(p):
        return block_ref[p].astype(jnp.int32)

    def u32le(p):
        return byte(p) | (byte(p + 1) << 8) | (byte(p + 2) << 16) \
            | (byte(p + 3) << 24)

    def hash4(p):
        """HashContext (src/libzling_lz.cpp:55-57): (check, hash slot)."""
        h = u32le(p) + byte(p + 2) * 137 + byte(p + 3) * 13337
        return _srl(h, 13) & 255, h & (BUCKET_ITEM_HASH - 1)

    def offset_of(base, node):
        return slot_ref[base + (node & _RING_MASK)] & 0xFFFFFF

    def common_length(p1, p2):
        neq = block_ref[pl.ds(p1, _LCP)] != block_ref[pl.ds(p2, _LCP)]
        first = jnp.min(jnp.where(neq, lanes, _LCP))
        return jnp.where(first >= MATCH_MIN_LEN,
                         jnp.minimum(first, MATCH_MAX_LEN), 0)

    def lazy_probe(p, maxlen, depth):
        """MatchLazy (src/libzling_lz.cpp:291-316): True when a candidate
        of context byte[p-1] matches the 4 bytes at p + maxlen - 3."""
        lctx = byte(p - 1)
        _, lslot = hash4(p)
        lnode = hash_ref[lctx * BUCKET_ITEM_HASH + lslot]
        base = lctx * BUCKET_ITEM_SIZE
        probe_at = maxlen - 3
        want = u32le(p + probe_at)

        def body(carry):
            i, node, hit, _done = carry
            offset = offset_of(base, node)
            h = u32le(offset + probe_at) == want
            nxt = chain_ref[base + node]
            done = h | (nxt == _NIL) | (offset <= offset_of(base, nxt)) \
                | (i + 1 >= depth)
            return i + 1, jnp.where(done, node, nxt), hit | h, done

        start_ok = lnode != _NIL
        _, _, hit, _ = jax.lax.while_loop(
            lambda c: ~c[3], body,
            (p - p, jnp.where(start_ok, lnode, 0), p < 0, ~start_ok))
        return hit

    def match_and_update(pos, depth, lazy1, lazy2):
        """MatchAndUpdate (src/libzling_lz.cpp:211-289): insert pos into
        its bucket, walk the chain, then the lazy probes."""
        ctx = byte(pos - 1)
        check, hslot = hash4(pos)
        hidx = ctx * BUCKET_ITEM_HASH + hslot
        base = ctx * BUCKET_ITEM_SIZE
        node0 = hash_ref[hidx]
        head = (head_ref[ctx] + 1) & _RING_MASK
        head_ref[ctx] = head
        chain_ref[base + head] = node0
        slot_ref[base + head] = pos | (check << 24)
        hash_ref[hidx] = head
        searchable = (node0 != _NIL) & (node0 != head)

        def walk(carry):
            i, node, best_len, best_node, _done = carry
            s = slot_ref[base + node]
            offset = s & 0xFFFFFF
            probe_ok = (_srl(s, 24) == check) & (
                byte(pos + best_len) == byte(offset + best_len))
            lcp = jax.lax.cond(probe_ok, common_length,
                               lambda a, b: a - a, pos, offset)
            better = lcp > best_len
            best_node = jnp.where(better, node, best_node)
            best_len = jnp.where(better, lcp, best_len)
            nxt = chain_ref[base + node]
            done = (best_len == MATCH_MAX_LEN) | (nxt == _NIL) \
                | (offset <= offset_of(base, nxt)) | (i + 1 >= depth)
            return i + 1, jnp.where(done, node, nxt), best_len, best_node, done

        _, _, best_len, best_node, _ = jax.lax.while_loop(
            lambda c: ~c[4], walk,
            (pos - pos, jnp.where(searchable, node0, 0),
             pos - pos + (MATCH_MIN_LEN - 1), pos - pos, ~searchable))
        found = searchable & (best_len >= MATCH_MIN_LEN)
        do_lazy = found & (best_len < MATCH_MIN_LEN_ENABLE_LAZY)

        def no_hit(p, maxlen, depth):
            return p < 0

        hit1 = jax.lax.cond(do_lazy & (lazy1 > 0), lazy_probe, no_hit,
                            pos + 1, best_len, lazy1)
        hit2 = jax.lax.cond(do_lazy & (lazy2 > 0) & ~hit1, lazy_probe,
                            no_hit, pos + 2, best_len, lazy2)
        return (found & ~hit1 & ~hit2, best_len,
                (head - best_node) & _RING_MASK)

    def no_match(pos, depth, lazy1, lazy2):
        return pos < 0, pos - pos, pos - pos

    def chunk(carry):
        ipos, cidx = carry
        depth = kmeta_ref[4 + 3 * cidx]
        lazy1 = kmeta_ref[5 + 3 * cidx]
        lazy2 = kmeta_ref[6 + 3 * cidx]
        mru_ref[pl.ds(0, 512)] = jnp.zeros((512,), jnp.int32)
        route.barrier(interpret)
        ubase = cidx * chunk_units

        def unit(carry):
            ipos, nu, nt = carry
            is_head = ipos <= 1  # raw block-head bytes (libzling_lz.cpp:150)
            found, mlen, midx = jax.lax.cond(
                ~is_head & (ipos < match_limit), match_and_update, no_match,
                ipos, depth, lazy1, lazy2)

            # exact reference semantics: the zero-initialized word-MRU does
            # match word 0x0000 (src/libzling_lz.cpp:147,172-185)
            ctx = byte(jnp.maximum(ipos - 1, 0))
            cur = byte(ipos)
            ww = cur * 256 + byte(ipos + 1)
            can_word = ~is_head & ~found & (ipos + 1 < ilen)
            hit0 = can_word & (mru_ref[ctx * 2] == ww)
            hit1 = can_word & ~hit0 & (mru_ref[ctx * 2 + 1] == ww)
            is_word = hit0 | hit1
            is_lit = ~is_head & ~found & ~is_word

            sym = jnp.where(found, 258 + mlen - MATCH_MIN_LEN,
                            jnp.where(hit0, 256, jnp.where(hit1, 257, cur)))
            i32 = jnp.int32
            kind = jnp.where(is_head, i32(KIND_RAW), jnp.where(
                found, i32(KIND_MATCH), jnp.where(is_word, i32(KIND_WORD),
                                                  i32(KIND_LITERAL))))
            aux = jnp.where(found, midx, jnp.where(is_lit, ctx, 0))
            units_ref[ubase + nu] = sym | (kind << 10) | (aux << 14)

            new_ipos = ipos + jnp.where(found, mlen,
                                        jnp.where(is_word, i32(2), i32(1)))
            # word-MRU (libzling_lz.cpp:163-166,178-191): a match pushes
            # when the word differs, word 0 never, word 1 and literals always
            # (clamped: at the block head these precede the block's start)
            cu = byte(jnp.maximum(new_ipos - 3, 0))
            wu = byte(jnp.maximum(new_ipos - 2, 0)) * 256 + byte(new_ipos - 1)
            old0 = mru_ref[cu * 2]

            @pl.when(~is_head & jnp.where(found, old0 != wu, ~hit0))
            def _():
                mru_ref[cu * 2 + 1] = old0
                mru_ref[cu * 2] = wu

            return new_ipos, nu + 1, nt + 1 + found.astype(jnp.int32)

        def unit_cond(carry):
            ipos, nu, nt = carry
            budget = jnp.where(ipos <= 1, nt < max_tokens, nt + 1 < max_tokens)
            return (ipos < ilen) & budget & (nu < chunk_units)

        ipos, nu, nt = jax.lax.while_loop(
            unit_cond, unit, (ipos, ipos - ipos, ipos - ipos))
        stat_ref[cidx, 0] = nu
        stat_ref[cidx, 1] = nt
        stat_ref[cidx, 2] = ipos
        return ipos, cidx + 1

    def zero_stat(i, carry):
        for k in range(4):
            stat_ref[i, k] = carry
        return carry

    jax.lax.fori_loop(0, max_chunks + 1, zero_stat, ilen - ilen)
    ipos, n_chunks = jax.lax.while_loop(
        lambda c: (c[0] < ilen) & (c[1] < max_chunks), chunk,
        (ilen - ilen, ilen - ilen))
    stat_ref[max_chunks, 0] = n_chunks
    stat_ref[max_chunks, 2] = ipos


@functools.partial(jax.jit, static_argnames=("max_chunks", "chunk_units",
                                             "interpret"))
def tokenize_block(block, ilen, levels, max_tokens, *, max_chunks: int,
                   chunk_units: int, interpret: bool):
    """Tokenize one block as its chunk sequence (jit / shard_map safe).

    block: [B] u8, zero-padded by >= BLOCK_PAD bytes beyond ilen; levels:
    [max_chunks] per-chunk level ids (0..6); max_tokens: tokens per chunk.
    Returns (units [max_chunks, chunk_units] i32 packed words, valid below
    each chunk's unit count; stat [max_chunks + 1, 4] i32: per chunk
    (units, tokens, end position), then (chunks, 0, end position, 0)).
    """
    i32 = jnp.int32
    lv = jnp.asarray(_LEVEL_TABLE)[jnp.clip(levels, 0, len(LEVEL_PARAMS) - 1)]
    kmeta = jnp.concatenate([
        jnp.stack([ilen, max_tokens, 0, 0]).astype(i32),
        lv.reshape(-1).astype(i32)])
    units, stat, *_ = route.pallas_call(
        functools.partial(_tokenize_kernel, max_chunks=max_chunks,
                          chunk_units=chunk_units, interpret=interpret),
        interpret=interpret,
        out_shape=(jax.ShapeDtypeStruct((max_chunks * chunk_units,), i32),
                   jax.ShapeDtypeStruct((max_chunks + 1, 4), i32),
                   jax.ShapeDtypeStruct((256 * BUCKET_ITEM_HASH,), i32),
                   jax.ShapeDtypeStruct((256 * BUCKET_ITEM_SIZE,), i32),
                   jax.ShapeDtypeStruct((256 * BUCKET_ITEM_SIZE,), i32),
                   jax.ShapeDtypeStruct((256,), i32),
                   jax.ShapeDtypeStruct((512,), i32)),
        input_output_aliases={2: 2, 3: 3, 4: 4, 5: 5, 6: 6},
        name="zling_tokenize",
    )(kmeta, block,
      jnp.full(256 * BUCKET_ITEM_HASH, _NIL, i32),
      jnp.full(256 * BUCKET_ITEM_SIZE, _NIL, i32),
      jnp.zeros(256 * BUCKET_ITEM_SIZE, i32),
      jnp.zeros(256, i32), jnp.zeros(512, i32))
    return units.reshape(max_chunks, chunk_units), stat


def unpack_units(units):
    """Packed unit words -> (sym, kind, match idx, literal context)."""
    sym = units & 1023
    kind = (units >> 10) & 3
    aux = _srl(units, 14)
    return (sym, kind, jnp.where(kind == KIND_MATCH, aux & _RING_MASK, 0),
            aux & 255)
