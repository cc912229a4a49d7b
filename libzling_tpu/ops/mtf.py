"""Sticky move-to-front state and its sequential oracle.

The reference applies MTF inline, one literal at a time, inside the ROLZ
loops (src/libzling_lz.cpp:112-126,188,333).  MTF state is the one
cross-block dependency of the format (SURVEY.md section 0.3): the 256
per-context permutations persist for the whole stream.  Tokenization does
not depend on MTF *values*, so the device encoder emits raw literal bytes
and relabels them afterwards (ops/relabel_kernel.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..tables import MTF_INIT, MTF_NEXT


def initial_state() -> tuple[jnp.ndarray, jnp.ndarray]:
    """(rank2sym, sym2rank), each [256 contexts, 256], int32."""
    r2s = np.tile(MTF_INIT[None, :], (256, 1)).astype(np.int32)
    s2r = np.zeros((256, 256), np.int32)
    s2r[np.arange(256)[:, None], r2s] = np.arange(256)[None, :]
    return jnp.asarray(r2s), jnp.asarray(s2r)


def encode_relabel_reference(rank2sym, sym2rank, lit_ctx, lit_raw):
    """NumPy oracle for tests: sequential per-literal relabel."""
    r2s = np.array(rank2sym)
    s2r = np.array(sym2rank)
    nxt = np.asarray(MTF_NEXT)
    out = np.zeros(len(lit_ctx), np.int32)
    for t, (c, sym) in enumerate(zip(lit_ctx, lit_raw)):
        i = s2r[c, sym]
        j = nxt[i]
        other = r2s[c, j]
        s2r[c, sym], s2r[c, other] = j, i
        r2s[c, i], r2s[c, j] = other, sym
        out[t] = i
    return out, r2s, s2r
