"""Device-side Huffman stage: canonical tables, histograms, bit-packing.

The reference interleaves Huffman coding with scalar loops in its driver
(src/libzling.cpp:210-257 encode, :336-402 decode).  Here the stage is
re-formulated as array programs:

* canonical code assignment and decode-LUT construction are vectorized and
  batched over chunks (each chunk has its own pair of tables);
* the encoder packs all symbols at once: per-unit bit patterns, an exclusive
  scan for bit offsets, and two scatter-ORs into the output words.

Decoding is bit-serial per chunk and runs in ops/entropy_kernel.py.

Exact code-length construction (heap tie-breaking, reference
src/libzling_huffman.cpp:41-112) stays on the host: see
``exact_length_tables`` which batches into the native engine.
"""

from __future__ import annotations

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..tables import (
    HUFFMAN_CODES_1,
    HUFFMAN_CODES_2,
    HUFFMAN_MAX_LEN_1,
    HUFFMAN_MAX_LEN_2,
    MATCHIDX_BASE,
    MATCHIDX_BLEN,
    MATCHIDX_CODE,
)

MAX_UNIT_BITS = HUFFMAN_MAX_LEN_1 + HUFFMAN_MAX_LEN_2 + 8  # 15+8+8 = 31
N_ENTRY = 32  # entry offsets 0..31 (a unit ending <=31 bits past a boundary)


# ---------------------------------------------------------------------------
# host: exact length tables (native engine batch call)
# ---------------------------------------------------------------------------


def exact_length_tables(freqs: np.ndarray, max_codelen: int) -> np.ndarray:
    """freqs [C, n] uint32 -> lengths [C, n] uint32, reference tie-breaking."""
    from ..native.engine import _lib

    dll = _lib()
    if not hasattr(dll, "_zlt_lengths_ready"):
        dll.zlt_length_tables.restype = None
        dll.zlt_length_tables.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        dll._zlt_lengths_ready = True
    freqs = np.ascontiguousarray(freqs, dtype=np.uint32)
    c, n = freqs.shape
    out = np.zeros((c, n), dtype=np.uint32)
    dll.zlt_length_tables(freqs.ctypes.data, c, n, max_codelen, out.ctypes.data)
    return out


# ---------------------------------------------------------------------------
# device: canonical encode tables from lengths
# ---------------------------------------------------------------------------


def _bitrev16(x: jnp.ndarray) -> jnp.ndarray:
    x = ((x & 0xFF00) >> 8) | ((x & 0x00FF) << 8)
    x = ((x & 0xF0F0) >> 4) | ((x & 0x0F0F) << 4)
    x = ((x & 0xCCCC) >> 2) | ((x & 0x3333) << 2)
    x = ((x & 0xAAAA) >> 1) | ((x & 0x5555) << 1)
    return x


@functools.partial(jax.jit, static_argnames=("max_codelen",))
def canonical_codes(lengths: jnp.ndarray, max_codelen: int) -> jnp.ndarray:
    """lengths [..., n] -> LSB-first bit-reversed canonical codes [..., n].

    Mirrors ZlingMakeEncodeTable (src/libzling_huffman.cpp:114-138):
    codes assigned shorter-first then symbol order, then bit-reversed and
    right-aligned to the code length.
    """
    lengths = lengths.astype(jnp.int32)
    n = lengths.shape[-1]
    # per-tier counts and starting code values
    onehot = jax.nn.one_hot(lengths, max_codelen + 1, dtype=jnp.int32)  # [..., n, L+1]
    tier_count = onehot.sum(axis=-2)  # [..., L+1]
    # c_{l+1} = (c_l + count_l) * 2, c_1 = 0  (l from 1)
    def step(c, cnt):
        return (c + cnt) * 2, c

    _, tier_start = jax.lax.scan(
        step,
        jnp.zeros(lengths.shape[:-1], dtype=jnp.int32),
        jnp.moveaxis(tier_count, -1, 0)[1:],  # lengths 1..L
    )
    tier_start = jnp.moveaxis(tier_start, 0, -1)  # [..., L] for lengths 1..L
    # rank of each symbol within its tier (symbol order)
    rank = jnp.cumsum(onehot, axis=-2) - onehot  # [..., n, L+1]
    rank_own = jnp.take_along_axis(rank, lengths[..., None], axis=-1)[..., 0]
    start_cat = jnp.concatenate(
        [jnp.zeros_like(tier_start[..., :1]), tier_start], axis=-1)  # [..., L+1]
    start_own = jnp.take_along_axis(start_cat, lengths, axis=-1)
    code = start_own + rank_own
    rev = _bitrev16(code.astype(jnp.uint32))
    shift = jnp.where(lengths > 0, 16 - lengths, 16).astype(jnp.uint32)
    out = jnp.where(lengths > 0, rev >> shift, 0)
    del n
    return out.astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("max_codelen",))
def decode_lut(lengths: jnp.ndarray, max_codelen: int) -> jnp.ndarray:
    """lengths [..., n] -> LUT [..., 2**max_codelen] mapping peeked (LSB-first)
    bit windows to symbols; 0xFFFF marks unused windows.

    Equivalent to ZlingMakeDecodeTable (src/libzling_huffman.cpp:140-153) but
    built by classifying every window value in parallel: reverse the window,
    then the canonical prefix property picks the unique length tier whose
    MSB-first range contains the window's top bits.
    """
    lengths = lengths.astype(jnp.int32)
    L = max_codelen
    onehot = jax.nn.one_hot(lengths, L + 1, dtype=jnp.int32)
    tier_count = onehot.sum(axis=-2)

    def step(c, cnt):
        return (c + cnt) * 2, c

    _, tier_start = jax.lax.scan(
        step, jnp.zeros(lengths.shape[:-1], dtype=jnp.int32),
        jnp.moveaxis(tier_count, -1, 0)[1:],
    )
    tier_start = jnp.moveaxis(tier_start, 0, -1)  # [..., L]
    tier_count_l = tier_count[..., 1:]  # [..., L]
    # symbols sorted by (length, symbol) with zero-length symbols last
    n = lengths.shape[-1]
    sort_key = jnp.where(lengths > 0, lengths, L + 1) * n + jnp.arange(n, dtype=jnp.int32)
    order = jnp.argsort(sort_key, axis=-1)  # [..., n]
    tier_base = jnp.cumsum(tier_count_l, axis=-1) - tier_count_l  # [..., L]

    v = jnp.arange(1 << L, dtype=jnp.uint32)
    rv = _bitrev16(v) >> (16 - L)  # MSB-first view of each window
    shape = lengths.shape[:-1]
    rv = jnp.broadcast_to(rv, shape + (1 << L,)).astype(jnp.int32)

    sym = jnp.full(shape + (1 << L,), 0xFFFF, dtype=jnp.int32)
    found = jnp.zeros(shape + (1 << L,), dtype=jnp.bool_)
    for l in range(1, L + 1):
        top = rv >> (L - l)
        c_l = tier_start[..., l - 1:l]
        n_l = tier_count_l[..., l - 1:l]
        hit = (~found) & (top >= c_l) & (top < c_l + n_l) & (n_l > 0)
        pos = jnp.clip(tier_base[..., l - 1:l] + top - c_l, 0, n - 1)
        cand = jnp.take_along_axis(order, pos, axis=-1)
        sym = jnp.where(hit, cand, sym)
        found = found | hit
    return sym.astype(jnp.uint16)


# ---------------------------------------------------------------------------
# device: encoder bit-packing
# ---------------------------------------------------------------------------

# kept as host numpy so importing this module never initializes a device
# backend (the constants embed into jitted programs at trace time)
_NP_MATCHIDX_CODE = np.asarray(MATCHIDX_CODE, dtype=np.int32)
_NP_MATCHIDX_BASE = np.asarray(MATCHIDX_BASE, dtype=np.int32)
_NP_MATCHIDX_BLEN = np.asarray(MATCHIDX_BLEN, dtype=np.int32)


def _J_MATCHIDX_CODE():
    return jnp.asarray(_NP_MATCHIDX_CODE)


def _J_MATCHIDX_BASE():
    return jnp.asarray(_NP_MATCHIDX_BASE)


def _J_MATCHIDX_BLEN():
    return jnp.asarray(_NP_MATCHIDX_BLEN)


@jax.jit
def unit_histograms(sym: jnp.ndarray, idx: jnp.ndarray, valid: jnp.ndarray):
    """Per-chunk symbol frequencies.

    sym/idx/valid: [U] padded unit arrays (sym in 0..513; idx valid for
    sym>=258).  Returns freq1 [514], freq2 [32] (uint32).
    """
    w = valid.astype(jnp.uint32)
    freq1 = jnp.zeros(HUFFMAN_CODES_1, jnp.uint32).at[sym].add(w, mode="drop")
    code2 = _J_MATCHIDX_CODE()[jnp.clip(idx, 0, 4095)]
    is_match = valid & (sym >= 258)
    freq2 = jnp.zeros(HUFFMAN_CODES_2, jnp.uint32).at[code2].add(
        is_match.astype(jnp.uint32), mode="drop")
    return freq1, freq2


@functools.partial(jax.jit, static_argnames=("out_words",))
def pack_units(sym, idx, valid, len1, enc1, len2, enc2, out_words: int):
    """Bit-pack one chunk's units into LSB-first u32 words.

    A unit is one alphabet-1 symbol plus, for matches, its index code and
    extra bits -- at most 31 bits, so each unit straddles at most two words.
    Returns (words [out_words] uint32, total_bits scalar).
    """
    sym = sym.astype(jnp.int32)
    # combine the per-unit lookups into TWO unit-sized gathers -- a packed
    # (code | len<<16) alphabet-1 table, and
    # a per-idx table that precomputes the ENTIRE match-index tail
    # (idxcode | extra_bits << len2) plus its bit count for all 4096 index
    # values (the small 4096/32-entry builder gathers are noise)
    packed1 = enc1.astype(jnp.uint32) | (len1.astype(jnp.uint32) << 16)
    p1 = packed1[sym]
    c1 = p1 & jnp.uint32(0xFFFF)
    l1 = p1 >> 16
    code2 = _J_MATCHIDX_CODE()
    l2t = len2[code2].astype(jnp.uint32)
    c2t = enc2[code2].astype(jnp.uint32)
    lxt = _J_MATCHIDX_BLEN()[code2].astype(jnp.uint32)
    cxt = (jnp.arange(4096, dtype=jnp.uint32)
           - _J_MATCHIDX_BASE()[code2].astype(jnp.uint32))
    # tail < 2^(len2+blen) <= 2^16; bit count <= 16 rides in the top byte
    idxtab = (c2t | (cxt << l2t)) | ((l2t + lxt) << 24)
    is_match = sym >= 258
    pi = jnp.where(is_match, idxtab[jnp.clip(idx, 0, 4095)], 0)

    bits = c1 | ((pi & jnp.uint32(0xFFFFFF)) << l1)
    nbits = jnp.where(valid, l1 + (pi >> 24), 0)

    offs = jnp.cumsum(nbits) - nbits  # exclusive scan of bit offsets
    total_bits = offs[-1] + nbits[-1] if sym.shape[0] else jnp.uint32(0)

    word = (offs >> 5).astype(jnp.int32)
    shift = (offs & 31).astype(jnp.uint32)
    lo = jnp.where(valid, (bits << shift) & jnp.uint32(0xFFFFFFFF), 0)
    # bits spilling into the next word (shift by 32-shift; avoid UB at 0)
    hi = jnp.where(valid & (shift > 0), bits >> (32 - jnp.where(shift > 0, shift, 1)), 0)
    out = jnp.zeros(out_words, jnp.uint32)
    out = out.at[word].add(lo, mode="drop")
    out = out.at[word + 1].add(hi, mode="drop")
    return out, total_bits


def payload_from_words(words: np.ndarray, total_bits: int,
                       len1: np.ndarray, len2: np.ndarray) -> bytes:
    """Host: assemble the chunk payload (nibble-packed tables + bitstream)."""
    header = np.empty((HUFFMAN_CODES_1 + HUFFMAN_CODES_2) // 2, dtype=np.uint8)
    l1 = len1.astype(np.uint8)
    l2 = len2.astype(np.uint8)
    header[: HUFFMAN_CODES_1 // 2] = l1[0::2] * 16 + l1[1::2]
    header[HUFFMAN_CODES_1 // 2:] = l2[0::2] * 16 + l2[1::2]
    nbytes = (int(total_bits) + 7) // 8
    body = words.view(np.uint8)[:nbytes] if nbytes else np.empty(0, np.uint8)
    return header.tobytes() + body.tobytes()
