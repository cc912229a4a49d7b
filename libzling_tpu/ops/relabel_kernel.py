"""Pallas kernel (Triton route): sticky-MTF literal relabel.

The reference applies MTF inline per literal (src/libzling_lz.cpp:112-117,
188); the codec tokenizes with RAW literal bytes and relabels afterwards
(SURVEY.md section 7.0 phase b).  The 256 context chains are independent:
the literals are stably sorted by context (XLA, ``sort_literals``), then one
program walks all 256 runs in lockstep, one lane per context.  Each step
relabels the k-th literal of every context with four gathers and four
scatters into the [256, 256] rank<->symbol tables; a lane only touches its
own context's rows, so the step count is the longest run, not the number of
literals.

The tables are plain [256, 256] i32 arrays: small enough to carry between
blocks and around the mesh ring (parallel/mesh.py ppermute chain).

Oracle: ``mtf.encode_relabel_reference`` (tests/test_relabel_kernel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import route
from ..tables import MTF_NEXT


def _relabel_kernel(raw_ref, start_ref, len_ref, maxrun_ref, nxt_ref,
                    _r2s_in, _s2r_in, ranks_ref, r2s_ref, s2r_ref, *,
                    interpret: bool):
    row = jax.lax.broadcasted_iota(jnp.int32, (256,), 0) * 256
    run_start = start_ref[pl.ds(0, 256)]
    run_len = len_ref[pl.ds(0, 256)]

    def step(k, carry):
        active = k < run_len
        pos = run_start + k
        sym = pltriton.load(raw_ref.at[pos], mask=active, other=0)
        i = s2r_ref[row + sym]
        j = nxt_ref[i]
        other = r2s_ref[row + j]
        pltriton.store(r2s_ref.at[row + i], other, mask=active)
        pltriton.store(r2s_ref.at[row + j], sym, mask=active)
        pltriton.store(s2r_ref.at[row + sym], j, mask=active)
        pltriton.store(s2r_ref.at[row + other], i, mask=active)
        pltriton.store(ranks_ref.at[pos], i, mask=active)
        route.barrier(interpret)
        return carry

    max_run = maxrun_ref[0]
    jax.lax.fori_loop(0, max_run, step, max_run)


def sort_literals(lit_ctx, lit_raw, lit_valid):
    """Stable sort of the literals by context (traced).

    Returns (order, raw bytes in sorted order, run start [256], run length
    [256], longest run [1])."""
    key = jnp.where(lit_valid, lit_ctx.astype(jnp.int32), 256)
    order = jnp.argsort(key, stable=True)
    run_len = jnp.zeros(257, jnp.int32).at[key].add(1)[:256]
    run_start = jnp.cumsum(run_len) - run_len
    return (order, lit_raw.astype(jnp.int32)[order], run_start, run_len,
            jnp.max(run_len)[None])


@functools.partial(jax.jit, static_argnames=("interpret",))
def relabel_sorted(r2s, s2r, raw_s, run_start, run_len, max_run, *,
                   interpret: bool):
    """Relabel sorted literals; returns (ranks in sorted order, r2s', s2r').

    r2s/s2r: [256, 256] i32 rank->symbol and symbol->rank tables."""
    L = raw_s.shape[0]
    i32 = jnp.int32
    ranks, r2s, s2r = route.pallas_call(
        functools.partial(_relabel_kernel, interpret=interpret),
        interpret=interpret,
        out_shape=(jax.ShapeDtypeStruct((L,), i32),
                   jax.ShapeDtypeStruct((65536,), i32),
                   jax.ShapeDtypeStruct((65536,), i32)),
        input_output_aliases={5: 1, 6: 2},
        name="zling_mtf_relabel",
    )(raw_s, run_start, run_len, max_run,
      jnp.asarray(np.asarray(MTF_NEXT, np.int32)),
      r2s.reshape(-1).astype(i32), s2r.reshape(-1).astype(i32))
    return ranks, r2s.reshape(256, 256), s2r.reshape(256, 256)


def unsort(order, ranks_s, lit_valid):
    """Sorted-order ranks back to stream order (0 where not a literal)."""
    ranks = jnp.zeros_like(ranks_s).at[order].set(ranks_s)
    return jnp.where(lit_valid, ranks, 0)


def encode_relabel(r2s, s2r, lit_ctx, lit_raw, lit_valid, *, interpret: bool):
    """Relabel raw literal bytes to MTF ranks, in stream order.

    Mirrors ZlingMTFEncoder::Encode (src/libzling_lz.cpp:112-117) per
    context: i = rank(c); swap ranks i and MTF_NEXT[i].  Returns
    (ranks, r2s', s2r')."""
    order, raw_s, start, length, max_run = sort_literals(lit_ctx, lit_raw,
                                                          lit_valid)
    ranks_s, r2s, s2r = relabel_sorted(r2s, s2r, raw_s, start, length,
                                       max_run, interpret=interpret)
    return unsort(order, ranks_s, lit_valid), r2s, s2r
