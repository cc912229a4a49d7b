"""Pallas kernel (Triton route): per-chunk Huffman entropy decode.

The zling payload is a bit-serial stream (LSB-first canonical Huffman over
two alphabets, reference src/libzling.cpp:368-402).  Chunks decode
independently -- each carries its own tables (src/libzling.cpp:212-229) --
so the kernel runs one program per chunk over a grid of chunks, and a
stream of many chunks fills the card's SMs.  Inside a program the bit reader
is serial:

  * a 64-bit accumulator in two 32-bit words (lo, hi) with ``nbits`` valid
    bits; one unit consumes at most 15 + 8 + 8 = 31 bits, so topping up to
    >= 32 bits once per unit keeps every peek inside ``lo``;
  * alphabet 1 decodes through a 12-bit LUT (sym | len << 16); the rare
    13..15-bit codes take a canonical tier compare;
  * the match index (alphabet 2 + extra bits) decodes through an 8-bit LUT
    (len | extra_bits << 8 | base << 16);
  * the payload words are read straight from device memory.

Table construction is jitted XLA (``build_chunk_tables``); the host ships
only the nibble-unpacked length arrays.  The window classification mirrors
ZlingMakeDecodeTable semantics (reference src/libzling_huffman.cpp:114-153)
by classifying every window value by canonical tier ranges.

Oracle: ``spec.huffman_decode_chunk`` (tests/test_entropy_kernel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from . import route
from ..tables import (
    BLOCK_SIZE_ROLZ,
    HUFFMAN_CODES_1,
    HUFFMAN_MAX_LEN_1,
    HUFFMAN_MAX_LEN_2,
    MATCHIDX_BASE,
    MATCHIDX_BLEN,
)

LUT_BITS = 12                 # fast-path window width for alphabet 1
MAX_TOKENS = BLOCK_SIZE_ROLZ  # chunk token budget (kBlockSizeRolz)
PAD_WORDS = 128               # zero words after each chunk's payload
META = 64                     # per-chunk meta row, see build_chunk_tables


# ---------------------------------------------------------------------------
# device: table construction (vectorized over chunks, jitted)
# ---------------------------------------------------------------------------


def _bitrev(v: np.ndarray, bits: int) -> np.ndarray:
    v = v.astype(np.uint32)
    r = np.zeros_like(v)
    for _ in range(bits):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


def _canonical_tiers(lengths, max_len: int):
    """Per-chunk canonical code metadata.

    lengths: [C, n] i32.  Returns (start, count, base, order):
      start[C, L+1]: first MSB-first code value of each length tier;
      count[C, L+1]: symbols per tier;  base[C, L+1]: tier offset into order;
      order[C, n]: symbols sorted by (length, symbol id), zero-lengths last.
    """
    C, n = lengths.shape
    L = max_len
    onehot = (lengths[..., None] == jnp.arange(L + 1)).astype(jnp.int32)
    count = onehot.sum(axis=1).at[:, 0].set(0)
    starts = [jnp.zeros(C, jnp.int32)]
    c = jnp.zeros(C, jnp.int32)
    for l in range(1, L + 1):
        starts.append(c)
        c = (c + count[:, l]) * 2
    start = jnp.stack(starts, axis=1)
    base = jnp.cumsum(count, axis=1) - count
    key = jnp.where(lengths > 0, lengths, L + 1) * n + jnp.arange(n)
    order = jnp.argsort(key, axis=1).astype(jnp.int32)
    return start, count, base, order


def _classify_windows(start, count, base, order, max_len: int, lut_bits: int):
    """LUT[C, 2**lut_bits] -> sym | len << 16 (or -1 for miss / longer code).

    A window w (LSB-first peek) decodes as the unique length l whose
    MSB-first tier range contains bitrev(w)'s top l bits.
    """
    W = 1 << lut_bits
    v = jnp.asarray(_bitrev(np.arange(W, dtype=np.uint32), lut_bits)
                    .astype(np.int32))
    lut = jnp.full((start.shape[0], W), -1, jnp.int32)
    found = jnp.zeros((start.shape[0], W), bool)
    for l in range(1, min(max_len, lut_bits) + 1):
        top = v >> (lut_bits - l)
        s = start[:, l][:, None]
        cnt = count[:, l][:, None]
        hit = (~found) & (top >= s) & (top < s + cnt)
        pos = jnp.clip(base[:, l][:, None] + top - s, 0, order.shape[1] - 1)
        sym = jnp.take_along_axis(order, pos, axis=1)
        lut = jnp.where(hit, sym | (l << 16), lut)
        found = found | hit
    return lut


@jax.jit
def build_chunk_tables(len1, len2, n_words, word_base, rlens):
    """Per-chunk decode tables for the kernel.

    len1 [C, 514], len2 [C, 32]: code lengths from the chunk headers.
    n_words[C]: payload words plus the 2 words the bit reader may peek past
    the last payload byte (reference sentinel semantics,
    src/libzling.cpp:369-374).  word_base[C]: chunk start in the flat word
    array.  rlens[C]: token counts.

    Returns (meta [C, 64] i32, order1 [C, 1024] i32, lut1 [C, 4096] i32,
    lut2 [C, 256] i32).  meta row: 0 n_words, 1 rlen, 2 word_base;
    16 + l / 32 + l / 48 + l: tier start / count / base of code length l.
    """
    C = len1.shape[0]
    len1 = len1.astype(jnp.int32)
    len2 = len2.astype(jnp.int32)
    s1, c1, b1, o1 = _canonical_tiers(len1, HUFFMAN_MAX_LEN_1)
    lut1 = _classify_windows(s1, c1, b1, o1, HUFFMAN_MAX_LEN_1, LUT_BITS)

    s2, c2, b2, o2 = _canonical_tiers(len2, HUFFMAN_MAX_LEN_2)
    lut2sym = _classify_windows(s2, c2, b2, o2, HUFFMAN_MAX_LEN_2,
                                HUFFMAN_MAX_LEN_2)
    blen = jnp.asarray(np.asarray(MATCHIDX_BLEN, np.int32))
    mbase = jnp.asarray(np.asarray(MATCHIDX_BASE, np.int32))
    sym2 = jnp.clip(lut2sym & 0xFFFF, 0, 31)
    l2 = lut2sym >> 16
    lut2 = jnp.where(lut2sym >= 0,
                     l2 | (blen[sym2] << 8) | (mbase[sym2] << 16), -1)

    tiers = HUFFMAN_MAX_LEN_1 + 1
    meta = jnp.zeros((C, META), jnp.int32)
    meta = meta.at[:, 0].set(n_words.astype(jnp.int32))
    meta = meta.at[:, 1].set(rlens.astype(jnp.int32))
    meta = meta.at[:, 2].set(word_base.astype(jnp.int32))
    meta = meta.at[:, 16:16 + tiers].set(s1)
    meta = meta.at[:, 32:32 + tiers].set(c1)
    meta = meta.at[:, 48:48 + tiers].set(b1)
    order1 = jnp.zeros((C, 1024), jnp.int32).at[:, :HUFFMAN_CODES_1].set(o1)
    return meta, order1, lut1, lut2


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _srl(x, n):
    return jax.lax.shift_right_logical(x, n)


def _bitrev15(v):
    v = (_srl(v & 0xFF00, 8)) | ((v & 0x00FF) << 8)
    v = (_srl(v & 0xF0F0, 4)) | ((v & 0x0F0F) << 4)
    v = (_srl(v & 0xCCCC, 2)) | ((v & 0x3333) << 2)
    v = (_srl(v & 0xAAAA, 1)) | ((v & 0x5555) << 1)
    return _srl(v, 1)


def _decode_kernel(meta_ref, order_ref, lut1_ref, lut2_ref, words_ref,
                   tok_ref, status_ref):
    c = pl.program_id(0)
    n_words = meta_ref[c, 0]
    rlen = meta_ref[c, 1]
    wb = meta_ref[c, 2]

    def long_code(lo):
        # codes of 13..15 bits: compare the MSB-first 15-bit window against
        # each canonical tier (rare: the 12-bit LUT covers the rest)
        v15 = _bitrev15(lo & 0x7FFF)
        packed = jnp.int32(-1)
        for l in range(LUT_BITS + 1, HUFFMAN_MAX_LEN_1 + 1):
            top = _srl(v15, HUFFMAN_MAX_LEN_1 - l)
            s = meta_ref[c, 16 + l]
            hit = (packed < 0) & (top >= s) & (top < s + meta_ref[c, 32 + l])
            pos = jnp.clip(meta_ref[c, 48 + l] + top - s, 0, 1023)
            packed = jnp.where(hit, order_ref[c, pos] | (l << 16), packed)
        return packed

    def body(carry):
        wpos, lo, hi, nbits, emitted, bad = carry
        # refill (at most one word per unit): nbits >= 1 always
        fill = nbits < 32
        w = words_ref[wb + wpos]
        sh = jnp.minimum(nbits, 31)
        lo = jnp.where(fill, lo | (w << sh), lo)
        hi = jnp.where(fill, _srl(w, 32 - sh), hi)
        wpos = wpos + fill.astype(jnp.int32)
        nbits = nbits + jnp.where(fill, jnp.int32(32), jnp.int32(0))

        e = lut1_ref[c, lo & 0xFFF]
        ev = jax.lax.cond(e < 0, long_code, lambda _: e, lo)
        bad = bad | (ev < 0)
        ev = jnp.maximum(ev, 0)
        sym = ev & 0xFFFF
        l1 = jnp.maximum(_srl(ev, 16) & 31, 1)

        # the match index peeks straight out of lo at l1 and l1 + l2
        is_match = (sym >= 258) & (emitted + 1 < rlen)
        e2 = lut2_ref[c, _srl(lo, l1) & 0xFF]
        bad = bad | (is_match & (e2 < 0))
        e2 = jnp.maximum(e2, 0)
        l2 = e2 & 0xFF
        blen = _srl(e2, 8) & 0xFF
        extra = _srl(lo, l1 + l2) & ((jnp.int32(1) << blen) - 1)

        nc = l1 + jnp.where(is_match, l2 + blen, 0)
        lo = _srl(lo, nc) | (hi << (32 - nc))
        hi = _srl(hi, nc)
        nbits = nbits - nc
        # the index slot is written unconditionally (the row has slack)
        tok_ref[c, emitted] = sym
        tok_ref[c, emitted + 1] = _srl(e2, 16) + extra
        emitted = emitted + 1 + is_match.astype(jnp.int32)
        # overrun check: wpos grows by <= 1 per unit and every chunk has
        # PAD_WORDS zero words behind it, so detection is never late
        bad = bad | (wpos > n_words)
        return wpos, lo, hi, nbits, emitted, bad

    def cond(carry):
        return (carry[4] < rlen) & ~carry[5]

    wpos, _lo, _hi, nbits, emitted, bad = jax.lax.while_loop(
        cond, body, (jnp.int32(2), words_ref[wb], words_ref[wb + 1],
                     jnp.int32(64), jnp.int32(0), jnp.bool_(False)))
    bit_pos = wpos * 32 - nbits
    bad = bad | (bit_pos > n_words * 32)
    status_ref[c, 0] = emitted
    status_ref[c, 1] = bit_pos
    status_ref[c, 2] = bad.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("interpret", "max_tokens"))
def decode_tables(meta, order1, lut1, lut2, words, *, interpret: bool,
                  max_tokens: int = MAX_TOKENS):
    """Run the kernel over built tables; returns (tokens [C, max_tokens + 2]
    i32, status [C, 4] i32: emitted, bits consumed, bad)."""
    C = meta.shape[0]
    return route.pallas_call(
        _decode_kernel, interpret=interpret, grid=(C,),
        out_shape=(jax.ShapeDtypeStruct((C, max_tokens + 2), jnp.int32),
                   jax.ShapeDtypeStruct((C, 4), jnp.int32)),
        name="zling_entropy_decode",
    )(meta, order1, lut1, lut2, words)


def pack_payload_words(payloads: list[bytes], total_words: int | None = None):
    """Lay chunk payloads into one flat little-endian word array.

    Each chunk is followed by PAD_WORDS zero words: the bit reader
    legitimately peeks past the last payload byte (reference sentinel
    semantics, src/libzling.cpp:369-374) and a corrupt chunk is caught
    within one word of its end.  total_words (optional) zero-pads the
    result so callers can keep jit shapes stable across calls.
    Returns (words i32[W], word_base i32[C], n_words i32[C]).
    """
    C = len(payloads)
    word_base = np.zeros(C, np.int32)
    n_words = np.zeros(C, np.int32)
    flat = []
    base = 0
    for i, p in enumerate(payloads):
        nb = (len(p) + 3) // 4 * 4 + PAD_WORDS * 4
        flat.append(np.frombuffer(p + bytes(nb - len(p)), np.uint8))
        word_base[i] = base
        n_words[i] = len(p) // 4 + 2  # payload words + legal 8-byte overpeek
        base += nb // 4
    words = (np.concatenate(flat) if flat else np.zeros(0, np.uint8)) \
        .view("<u4").astype(np.int32)
    if total_words is not None:
        if len(words) > total_words:
            raise ValueError("payloads exceed total_words")
        words = np.pad(words, (0, total_words - len(words)))
    return words, word_base, n_words


def decode_chunks(len1: np.ndarray, len2: np.ndarray, payloads: list[bytes],
                  rlens: np.ndarray, *, interpret: bool,
                  max_tokens: int = MAX_TOKENS):
    """Decode all chunks' bitstreams to token arrays on device.

    len1/len2: [C, 514]/[C, 32] code lengths (headers already stripped).
    payloads: per-chunk bitstream bytes (without the 273-byte table header).
    Returns (tokens [C, max_tokens + 2] i32 device array, status [C, 4]:
    [c, 0] = tokens emitted, [c, 1] = bits consumed, [c, 2] = bad).
    """
    rlens = np.asarray(rlens, np.int32)
    if rlens.size and int(rlens.max()) > max_tokens:
        raise ValueError("zling: corrupt stream (chunk token count)")
    words, word_base, n_words = pack_payload_words(list(payloads))
    meta, order1, lut1, lut2 = build_chunk_tables(
        jnp.asarray(np.asarray(len1, np.int32)),
        jnp.asarray(np.asarray(len2, np.int32)),
        jnp.asarray(n_words), jnp.asarray(word_base), jnp.asarray(rlens))
    return decode_tables(meta, order1, lut1, lut2, jnp.asarray(words),
                         interpret=interpret, max_tokens=max_tokens)
