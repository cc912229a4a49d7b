"""Golden tests for the ROLZ tokenizer kernel (interpret mode on the CPU).

The oracle is the executable spec's chunk encoder (itself golden-tested
against the reference binary), driven chunk by chunk with the same level
schedule; literal units carry raw bytes, so the spec's MTF is applied to
them in unit order before comparing token streams.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp

from libzling_tpu import spec
from libzling_tpu.ops import tokenize_kernel as tk
from libzling_tpu.tables import SENTINEL_LEN


def run_kernel(data: bytes, levels, max_tokens, max_chunks, chunk_units):
    """Tokenize on the kernel; returns per-chunk (tokens, encpos, ntoks)."""
    block = np.zeros(len(data) + tk.BLOCK_PAD, np.uint8)
    block[:len(data)] = np.frombuffer(data, np.uint8)
    units, stat = tk.tokenize_block(
        jnp.asarray(block), jnp.int32(len(data)),
        jnp.asarray(np.asarray(levels, np.int32)), jnp.int32(max_tokens),
        max_chunks=max_chunks, chunk_units=chunk_units, interpret=True)
    units, stat = np.asarray(units), np.asarray(stat)
    mtf = spec.RolzEncoder().mtf  # one MTF chain for the whole block
    out = []
    for c in range(int(stat[max_chunks, 0])):
        toks = []
        for w in units[c, :stat[c, 0]].tolist():
            sym, kind, aux = w & 1023, (w >> 10) & 3, w >> 14
            if kind == tk.KIND_LITERAL:
                toks.append(mtf[aux & 255].encode(sym))
            else:
                toks.append(sym)
                if kind == tk.KIND_MATCH:
                    toks.append(aux & 4095)
        out.append((toks, int(stat[c, 2]), int(stat[c, 1])))
    return out


def run_spec(data: bytes, levels, max_tokens):
    enc = spec.RolzEncoder()
    enc.reset()
    buf = bytearray(data) + bytearray(SENTINEL_LEN)
    out, pos, c = [], 0, 0
    while pos < len(data):
        toks, pos = enc.encode_chunk(int(levels[c]), buf, len(data), pos,
                                     max_tokens)
        out.append((toks, pos, len(toks)))
        c += 1
    return out


@pytest.mark.parametrize("level,seed,size", [(0, 3, 3000), (2, 7, 5000)])
def test_tokenize_kernel_matches_oracle(level, seed, size):
    rng = np.random.default_rng(seed)
    text = (b"the quick brown fox jumps over the lazy dog. " * 200)[: size // 2]
    data = text + bytes(rng.integers(0, 256, size - len(text), dtype=np.uint8))
    max_tokens, max_chunks, chunk_units = 700, 12, 700
    levels = np.full(max_chunks, level, np.int32)
    levels[1] = 0  # mixed schedule mid-block
    assert run_kernel(data, levels, max_tokens, max_chunks, chunk_units) \
        == run_spec(data, levels, max_tokens)


def test_tokenize_kernel_extended_level():
    # e5 (deeper chain walks and lazy probes) is exact on the kernel
    data = (b"abcabcabd" * 120) + b"the quick brown fox " * 30
    levels = [5] * 4
    got = run_kernel(data, levels, 4000, 4, 4000)
    assert len(got) == 1
    assert got == run_spec(data, levels, 4000)


def test_mesh_encode_with_pallas_tokenizer():
    # the kernel lane slots into the canonical mesh path: byte-identical
    # stream (tiny data: the kernel interprets per unit on the CPU)
    import jax
    from libzling_tpu.parallel import mesh as pmesh

    rng = np.random.default_rng(11)
    data = (b"mesh tokenizer lane " * 60
            + bytes(rng.integers(0, 256, 800, dtype=np.uint8)))
    mesh = pmesh.make_mesh(jax.devices()[:2])
    stream = pmesh.mesh_encode(data, level=1, mesh=mesh, block_size=1024,
                               max_tokens=400)
    ref = spec.encode(data, level=1, block_size=1024, max_tokens=400)
    assert stream == ref
