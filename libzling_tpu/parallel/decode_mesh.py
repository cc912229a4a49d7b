"""Multi-device decode: sharded entropy decode feeding a pipelined resolve.

The zling stream's decode-side parallel axis is the CHUNK: every chunk
carries its own Huffman tables and decodes independently (reference
src/libzling.cpp:212-229).  The resolve stage is format-serial for
reference streams (ring contexts are decoded content, the MTF chain crosses
blocks -- DESIGN.md section 4), so it stays one chain.  This module scales
the parallel stage and pipelines the serial one:

  [devices 0..D-1]  per-chunk entropy decode, chunks sharded contiguously
                    over the mesh (ops/entropy_kernel.py per shard)
  [device 0]        the resolve chain (ops/resolve_kernel.py) consumes the
                    reassembled token stream

The stream is processed in GROUPS of whole blocks.  The resolve kernel
exports its exit MTF table (the only state crossing a block boundary; ring
and heads reset at block starts, the word-MRU per chunk), which feeds the
next group's resolve as a device-resident carry -- so the host dispatch
loop can enqueue group g+1's sharded entropy work while group g's resolve
chain is still executing (jax async dispatch).  All status and byte
fetches happen once at the end.

Geometry is padded to uniform shapes (chunks per device, payload words,
output bytes) so every group reuses the same compiled executables.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import container
from ..ops import entropy_kernel as ek
from ..ops import resolve_kernel as rk
from ..ops import route
from .mesh import AXIS, host_gather, make_mesh, shard_put


@functools.partial(jax.jit, static_argnames=("mesh", "interpret",
                                             "max_tokens"))
def _entropy_step(len1, len2, n_words, word_base, rlens, words, *,
                  mesh: Mesh, interpret: bool, max_tokens: int):
    """Sharded entropy decode: each device builds decode tables for and
    decodes its contiguous chunk range; the flat payload-word array is
    replicated (it is about the compressed size)."""

    def step(len1, len2, n_words, word_base, rlens, words):
        meta, order1, lut1, lut2 = ek.build_chunk_tables(
            len1, len2, n_words, word_base, rlens)
        tokens, status = ek.decode_tables(meta, order1, lut1, lut2, words,
                                          interpret=interpret,
                                          max_tokens=max_tokens)
        return tokens, status

    return jax.shard_map(
        step, mesh=mesh, check_vma=False,
        in_specs=(P(AXIS, None), P(AXIS, None), P(AXIS),
                  P(AXIS), P(AXIS), P(None)),
        out_specs=(P(AXIS, None), P(AXIS, None)),
    )(len1, len2, n_words, word_base, rlens, words)


def mesh_decode(data: bytes, mesh: Mesh | None = None,
                group_blocks: int = 1,
                max_tokens: int = ek.MAX_TOKENS) -> bytes:
    """Decode a zling stream with entropy decode sharded over the mesh.

    Bit-exact with ``spec.decode``; corrupt streams raise ValueError.  On a
    one-device mesh this is the "device" backend's decode (device.py).
    """
    if not data:
        return b""
    if mesh is None:
        mesh = make_mesh()
    D = mesh.devices.size
    interpret = route.interpret_mode(mesh.devices.flat[0])
    route.init_compile_cache()
    dev0 = mesh.devices.flat[0]
    # multi-process (jax.distributed): device 0 of the mesh may not be
    # addressable from this process, so the token reassembly and the serial
    # resolve run REPLICATED across all devices instead of pinned -- every
    # device executes the identical serial chain concurrently (same wall
    # time; resolve is format-serial anyway) and every process can fetch
    # the identical outputs without cross-process device access
    multiproc = jax.process_count() > 1
    replicated = jax.sharding.NamedSharding(mesh, P())

    chunks, block_sizes = container.parse(data)
    if not chunks:
        return b""
    len1, len2, bodies, rlens = container.unpack_length_tables(chunks)
    rlens = np.asarray(rlens, np.int32)
    if int(rlens.max()) > max_tokens:
        raise ValueError("zling: corrupt stream (chunk token count)")
    C = len(chunks)

    # ---- group structure: GROUP = group_blocks consecutive input blocks
    n_blocks = len(block_sizes)
    groups: list[tuple[int, int]] = []  # (first chunk idx, end chunk idx)
    blk_of = [ch.block_id for ch in chunks]
    for b0 in range(0, n_blocks, group_blocks):
        b1 = min(b0 + group_blocks, n_blocks)
        idx = [i for i in range(C) if b0 <= blk_of[i] < b1]
        groups.append((idx[0], idx[-1] + 1) if idx else (0, 0))

    # uniform geometry across groups (stable jit shapes)
    cd = max(1, max(-(-(c1 - c0) // D) for c0, c1 in groups))
    Cp = D * cd
    W = max(len(ek.pack_payload_words(bodies[c0:c1])[0])
            for c0, c1 in groups if c1 > c0)
    layouts = [rk.block_layout(block_sizes[b0:b0 + group_blocks])
               for b0 in range(0, n_blocks, group_blocks)]
    out_bytes = max(n for _, n in layouts)

    if multiproc:
        mtf = shard_put(rk.initial_mtf_state(), mesh, P())
        # one jitted all-gather reused across every group (uniform shapes
        # by construction -- a per-group lambda would retrace each time)
        gather_tokens = jax.jit(lambda x: x, out_shardings=replicated)
    else:
        mtf = jax.device_put(jnp.asarray(rk.initial_mtf_state()), dev0)

    fetched: list[tuple | None] = []
    for g, (c0, c1) in enumerate(groups):
        b0 = g * group_blocks
        cg = c1 - c0
        if cg == 0:
            fetched.append(None)
            continue

        # ---- entropy inputs, padded to Cp chunks (dummies: rlen=0)
        l1 = np.zeros((Cp, len1.shape[1]), np.int32)
        l2 = np.zeros((Cp, len2.shape[1]), np.int32)
        l1[:cg] = len1[c0:c1]
        l2[:cg] = len2[c0:c1]
        l1[cg:] = len1[c0]  # any valid table; dummy chunks decode nothing
        l2[cg:] = len2[c0]
        rl = np.zeros(Cp, np.int32)
        rl[:cg] = rlens[c0:c1]
        words, wb_g, nw_g = ek.pack_payload_words(bodies[c0:c1],
                                                  total_words=W)
        wb = np.zeros(Cp, np.int32)
        nw = np.full(Cp, 2, np.int32)
        wb[:cg] = wb_g
        nw[:cg] = nw_g

        tokens, estatus = _entropy_step(
            shard_put(l1, mesh, P(AXIS, None)),
            shard_put(l2, mesh, P(AXIS, None)),
            shard_put(nw, mesh, P(AXIS)),
            shard_put(wb, mesh, P(AXIS)),
            shard_put(rl, mesh, P(AXIS)),
            shard_put(words, mesh, P(None)),
            mesh=mesh, interpret=interpret, max_tokens=max_tokens)

        # ---- reassemble on device 0 and run the serial resolve chain
        # there; the MTF table carries group to group
        if multiproc:
            # all-gather to replicated: an XLA collective, legal from every
            # process -- unlike a cross-process device_put
            tokens0 = gather_tokens(tokens)
        elif D == 1:
            tokens0 = tokens
        else:
            tokens0 = jax.device_put(tokens, dev0)

        bases, _ = layouts[g]
        encpos = np.zeros(Cp, np.int32)
        new_block = np.zeros(Cp, np.int32)
        out_base = np.zeros(Cp, np.int32)
        prev_bid = -1
        for k in range(cg):
            ch = chunks[c0 + k]
            encpos[k] = ch.encpos
            if ch.block_id != prev_bid:
                new_block[k] = 1
                prev_bid = ch.block_id
            out_base[k] = bases[ch.block_id - b0]
        encpos[cg:] = encpos[cg - 1]  # dummies: no-op chunks of the
        out_base[cg:] = out_base[cg - 1]  # last real block

        out, rstatus, mtf = rk.resolve_stream(
            tokens0, rl, encpos, new_block, out_base, out_bytes,
            interpret=interpret, mtf0=mtf)
        fetched.append((out, rstatus, estatus, b0, cg, rl))
        # no host sync here: group g+1's entropy dispatches while group
        # g's resolve chain executes

    # ---- one sync point: validate statuses, slice block bytes
    parts: list[bytes] = []
    for item in fetched:
        if item is None:
            continue
        out, rstatus, estatus, b0, cg, rl = item
        if multiproc:
            # estatus is chunk-sharded (host_gather assembles it); out and
            # rstatus are replicated -- every process reads its local replica
            estatus = host_gather(estatus)
            rstatus = rstatus.addressable_data(0)
            out = out.addressable_data(0)
        est = np.asarray(estatus)[:cg]
        if est[:, 2].any() or (est[:, 0] != rl[:cg]).any():
            raise ValueError("zling: corrupt stream (huffman)")
        if np.asarray(rstatus)[:cg, 2].any():
            raise ValueError("zling: corrupt stream (resolve)")
        raw = np.asarray(out)
        bases, _ = layouts[b0 // group_blocks]
        for j, base in enumerate(bases):
            parts.append(raw[base: base + block_sizes[b0 + j]].tobytes())
    return b"".join(parts)
