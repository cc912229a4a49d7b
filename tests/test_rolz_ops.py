"""Device ROLZ tokenizer/resolver kernels + MTF relabel vs the executable
spec (kernels in interpret mode on the CPU)."""

import numpy as np
import pytest
import jax.numpy as jnp

from libzling_tpu import spec
from libzling_tpu.ops import mtf as mops
from libzling_tpu.ops import relabel_kernel as rlk
from libzling_tpu.ops import resolve_kernel as rk
from libzling_tpu.tables import SENTINEL_LEN

from .test_spec_vs_reference import _mixed_blob
from .test_tokenize_kernel import run_kernel


@pytest.mark.parametrize("level", [0, 2, 4])
def test_tokenize_matches_spec(level):
    data = _mixed_blob(30000, seed=level + 50)
    enc = spec.RolzEncoder()
    enc.reset()
    block = bytearray(data) + bytearray(SENTINEL_LEN)
    expect_tokens, expect_pos = enc.encode_chunk(level, block, len(data), 0)

    got_chunks = run_kernel(data, [level], 262144, 1, 65536)
    assert len(got_chunks) == 1
    got_tokens, got_pos, got_ntok = got_chunks[0]
    assert got_pos == expect_pos
    assert got_ntok == len(expect_tokens)
    assert got_tokens == expect_tokens


def test_tokenize_small_edge_cases():
    for data in (b"a", b"ab", b"abc", b"aaaaaaaaaaaaaaaa", bytes(300)):
        enc = spec.RolzEncoder()
        enc.reset()
        block = bytearray(data) + bytearray(SENTINEL_LEN)
        expect_tokens, expect_pos = enc.encode_chunk(0, block, len(data), 0)
        got_tokens, got_pos, _ = run_kernel(data, [0], 262144, 1, 512)[0]
        assert (got_tokens, got_pos) == (expect_tokens, expect_pos), data


def _resolve(tokens, encpos):
    toks = np.zeros((1, len(tokens) + 2), np.int32)
    toks[0, :len(tokens)] = tokens
    bases, out_bytes = rk.block_layout([encpos])
    out, status, _ = rk.resolve_stream(
        jnp.asarray(toks), [len(tokens)], [encpos], [1], bases, out_bytes,
        interpret=True)
    status = np.asarray(status)[0]
    return bytes(np.asarray(out)[:encpos]), int(status[0]), not status[2]


@pytest.mark.parametrize("level", [0, 4])
def test_resolve_roundtrip(level):
    data = _mixed_blob(30000, seed=7)
    enc = spec.RolzEncoder()
    enc.reset()
    block = bytearray(data) + bytearray(SENTINEL_LEN)
    tokens, encpos = enc.encode_chunk(level, block, len(data), 0)
    out, opos, ok = _resolve(tokens, encpos)
    assert ok
    assert opos == encpos
    assert out == data[:encpos]


def test_resolve_rejects_corrupt():
    data = b"hello world hello world hello hello hello world" * 20
    enc = spec.RolzEncoder()
    enc.reset()
    block = bytearray(data) + bytearray(SENTINEL_LEN)
    tokens, encpos = enc.encode_chunk(1, block, len(data), 0)
    # corrupt a match index to 0 (self-copy: reference would hang)
    bad = list(tokens)
    for i, t in enumerate(bad):
        if t >= 258:
            bad[i + 1] = 0
            break
    _, _, ok = _resolve(bad, encpos)
    assert not ok


@pytest.mark.parametrize("symbol", [-1, -256, -(1 << 31), 514])
def test_resolve_rejects_symbol_outside_alphabet(symbol):
    # token slots the entropy kernel left unwritten (it stops early on a
    # corrupt chunk) may hold anything; such a symbol must flag the chunk,
    # not index the MTF tables
    # the chunk ends in a literal, so no later token can expose the damage
    data = b"hello world hello world hello hello hello world" * 20 + b"#"
    enc = spec.RolzEncoder()
    enc.reset()
    block = bytearray(data) + bytearray(SENTINEL_LEN)
    tokens, encpos = enc.encode_chunk(1, block, len(data), 0)
    i = 0
    while i < len(tokens) - 1:
        i += 2 if tokens[i] >= 258 else 1
    assert i == len(tokens) - 1 and tokens[i] < 256
    _, _, ok = _resolve(tokens[:-1] + [symbol], encpos)
    assert not ok


def test_mtf_relabel_matches_reference():
    rng = np.random.default_rng(3)
    L = 5000
    ctx = rng.integers(0, 256, L).astype(np.int32)
    # skew contexts like text (few hot contexts)
    ctx[rng.random(L) < 0.5] = 32
    raw = rng.integers(0, 256, L).astype(np.int32)
    r2s, s2r = mops.initial_state()
    expect, er2s, es2r = mops.encode_relabel_reference(r2s, s2r, ctx, raw)
    got, gr2s, gs2r = rlk.encode_relabel(
        r2s, s2r, jnp.asarray(ctx), jnp.asarray(raw), jnp.ones(L, bool),
        interpret=True)
    assert np.asarray(got).tolist() == expect.tolist()
    assert np.array_equal(np.asarray(gr2s), er2s)
    assert np.array_equal(np.asarray(gs2r), es2r)
