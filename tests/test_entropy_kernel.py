"""Golden tests for the Pallas chunk-entropy-decode kernel.

Runs in Pallas interpret mode on the CPU backend (chip_smoke.py runs the
compiled kernel on a full chunk); token streams are round-tripped through
the executable spec's chunk entropy encoder (spec.huffman_encode_chunk) and
must decode back exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

from libzling_tpu import spec
from libzling_tpu.ops import entropy_kernel as ek
from libzling_tpu.tables import HUFFMAN_CODES_1, HUFFMAN_CODES_2

HDR = (HUFFMAN_CODES_1 + HUFFMAN_CODES_2) // 2


def _lengths_from_header(payload: bytes):
    nib = np.frombuffer(payload[:HDR], np.uint8)
    l1 = np.zeros(HUFFMAN_CODES_1, np.uint32)
    l2 = np.zeros(HUFFMAN_CODES_2, np.uint32)
    l1[0::2] = nib[: HUFFMAN_CODES_1 // 2] >> 4
    l1[1::2] = nib[: HUFFMAN_CODES_1 // 2] & 15
    l2[0::2] = nib[HUFFMAN_CODES_1 // 2:] >> 4
    l2[1::2] = nib[HUFFMAN_CODES_1 // 2:] & 15
    return l1, l2


def _make_tokens(rng, n_units, match_frac, sym_pool):
    toks: list[int] = []
    while len(toks) < n_units:
        if rng.random() < match_frac:
            toks.append(int(rng.integers(258, 514)))
            toks.append(int(rng.integers(1, 4096)))
        else:
            toks.append(int(rng.choice(sym_pool)))
    return toks


def _decode_with_kernel(cases):
    payloads, len1s, len2s, rlens = [], [], [], []
    for toks in cases:
        payload = spec.huffman_encode_chunk(toks)
        l1, l2 = _lengths_from_header(payload)
        payloads.append(payload[HDR:])
        len1s.append(l1)
        len2s.append(l2)
        rlens.append(len(toks))
    tokens, status = ek.decode_chunks(
        np.stack(len1s), np.stack(len2s), payloads, np.asarray(rlens),
        interpret=True, max_tokens=8192)
    return np.asarray(tokens), np.asarray(status)


def test_kernel_decodes_chunk_batch():
    rng = np.random.default_rng(7)
    # Fibonacci-weighted symbol counts build a maximally skewed Huffman tree,
    # forcing codes past LUT_BITS into the tier-compare fallback path
    # 16 terms -> tree depth exactly 15 (deeper would trigger the rescale
    # loop, which flattens the tree back under the LUT width)
    fib = [1, 1]
    while len(fib) < 16:
        fib.append(fib[-1] + fib[-2])
    skewed = np.concatenate([np.full(k, s, np.int64) for s, k in enumerate(fib)])
    cases = [
        _make_tokens(rng, 400, 0.0, np.arange(256)),   # literals only
        _make_tokens(rng, 900, 0.4, np.arange(256)),   # mixed matches
        skewed[rng.permutation(len(skewed))].tolist(),  # rare syms -> long codes
        [65, 66],                                      # tiny chunk
        _make_tokens(rng, 600, 0.3, np.arange(64)),    # crosses slab + flush
    ]
    # the skewed case must actually exercise the >LUT_BITS fallback path
    payload = spec.huffman_encode_chunk(cases[2])
    l1, _ = _lengths_from_header(payload)
    assert l1.max() > ek.LUT_BITS, "skewed case no longer covers the fallback"

    tokens, status = _decode_with_kernel(cases)
    assert not status[:, 2].any(), "kernel flagged a valid stream as bad"
    for c, toks in enumerate(cases):
        assert status[c, 0] == len(toks)
        assert tokens[c, : len(toks)].tolist() == toks


def test_kernel_rejects_truncated_stream():
    rng = np.random.default_rng(11)
    toks = _make_tokens(rng, 500, 0.3, np.arange(256))
    payload = spec.huffman_encode_chunk(toks)
    l1, l2 = _lengths_from_header(payload)
    body = payload[HDR:]
    # claim more tokens than the bitstream holds: the reader must stop at the
    # padded end (bad flag) instead of running away
    tokens, status = ek.decode_chunks(
        np.stack([l1]), np.stack([l2]), [body[: len(body) // 4]],
        np.asarray([len(toks)]), interpret=True, max_tokens=8192)
    status = np.asarray(status)
    assert status[0, 2] == 1 or status[0, 0] < len(toks)
