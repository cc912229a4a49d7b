"""Golden tests for the MTF relabel kernel (interpret mode on the CPU).

Oracle: ops/mtf.py encode_relabel_reference (the sequential NumPy port of
ZlingMTFEncoder, src/libzling_lz.cpp:112-117).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from libzling_tpu.ops import mtf as mops
from libzling_tpu.ops import relabel_kernel as rlk


def _literals(rng, n, hot_frac=0.5):
    ctx = rng.integers(0, 256, n).astype(np.int32)
    ctx[rng.random(n) < hot_frac] = 32   # skew contexts like text
    raw = rng.integers(0, 256, n).astype(np.int32)
    valid = rng.random(n) < 0.8          # units that are not literals
    return ctx, raw, valid


def test_relabel_kernel_matches_reference():
    rng = np.random.default_rng(5)
    ctx, raw, valid = _literals(rng, 3000)
    r2s, s2r = mops.initial_state()
    got, r2s2, s2r2 = rlk.encode_relabel(
        r2s, s2r, jnp.asarray(ctx), jnp.asarray(raw), jnp.asarray(valid),
        interpret=True)
    ranks, r2s_ref, s2r_ref = mops.encode_relabel_reference(
        np.asarray(r2s), np.asarray(s2r), ctx[valid], raw[valid])
    got = np.asarray(got)
    assert got[valid].tolist() == ranks.tolist()
    assert not got[~valid].any()
    assert np.array_equal(np.asarray(r2s2), r2s_ref)
    assert np.array_equal(np.asarray(s2r2), s2r_ref)

    # carried state: a second block continues the chain exactly
    ctx_b, raw_b, valid_b = _literals(rng, 700, hot_frac=0.9)
    got_b, r2s3, s2r3 = rlk.encode_relabel(
        r2s2, s2r2, jnp.asarray(ctx_b), jnp.asarray(raw_b),
        jnp.asarray(valid_b), interpret=True)
    ranks_b, r2s_ref2, s2r_ref2 = mops.encode_relabel_reference(
        r2s_ref, s2r_ref, ctx_b[valid_b], raw_b[valid_b])
    assert np.asarray(got_b)[valid_b].tolist() == ranks_b.tolist()
    assert np.array_equal(np.asarray(r2s3), r2s_ref2)
    assert np.array_equal(np.asarray(s2r3), s2r_ref2)


def test_sort_literals_runs():
    # the lockstep walk relies on contiguous, stream-ordered context runs
    rng = np.random.default_rng(1)
    ctx, raw, valid = _literals(rng, 500)
    order, raw_s, start, length, max_run = (
        np.asarray(a) for a in rlk.sort_literals(
            jnp.asarray(ctx), jnp.asarray(raw), jnp.asarray(valid)))
    for c in range(256):
        idx = np.flatnonzero(valid & (ctx == c))
        assert length[c] == len(idx)
        run = order[start[c]: start[c] + length[c]]
        assert run.tolist() == idx.tolist()
        assert raw_s[start[c]: start[c] + length[c]].tolist() \
            == raw[idx].tolist()
    assert int(max_run[0]) == int(length.max())
    assert int(length.sum()) == int(valid.sum())
