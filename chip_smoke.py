#!/usr/bin/env python3
"""Smoke check of the codec's device path on NVIDIA GPUs.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py             # one card: phases 1-5
    python chip_smoke.py --chips 4   # four cards: the multi-card path only

One card:
  1. identity: the card's name and power limit, JAX's view of the devices
     and the host's core count; exits non-zero unless the platform is gpu;
  2. compile: every kernel and the jitted encode step at canonical widths,
     with each compiled program's memory analysis;
  3. kernels against plain references at real widths: entropy decode of a
     full 262,143-token chunk against ``spec.huffman_decode_chunk``, the MTF
     relabel of a block's literals against ``mtf.encode_relabel_reference``,
     and one 16 MB block's device stream against the native engine's;
  4. end to end on 32 MB of generated text at e0 and e4: ``api.encode``
     with backend "device" equals the native engine's stream byte for byte;
     ``api.decode`` with backends "device" (of both streams) and "jax"
     returns the input.  Prints compile and warm wall times as smoke
     timings beside the card's name and power limit;
  5. the last line is the JSON result.

Four cards (``--chips 4``): ``mesh_encode`` of 128 MB (two groups of four
16 MB blocks) over the four cards at e0 and e4 equals the native stream,
and ``mesh_decode`` over the four cards returns the input.  For comparison,
the same decodes and the e0 encode also run on one card of the machine.
Each prints its first-call and warm wall times.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

SEED = 20261016
MB = 1 << 20


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def identity(chips: int):
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (platform={dev.platform!r})",
              file=sys.stderr)
        raise SystemExit(2)
    if len(devices) < chips:
        print(f"chip_smoke: need {chips} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        raise SystemExit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    print(f"[identity] jax {jax.__version__} platform={dev.platform} "
          f"device_kind={dev.device_kind} count={len(devices)} "
          f"host_cores={os.cpu_count()}", flush=True)
    return card.splitlines()[0], devices[:chips]


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    return (f"args {m.argument_size_in_bytes / MB:.1f} MiB, "
            f"outputs {m.output_size_in_bytes / MB:.1f} MiB, "
            f"temps {m.temp_size_in_bytes / MB:.1f} MiB, "
            f"aliased {m.alias_size_in_bytes / MB:.1f} MiB")


def compile_phase(dev, stream: bytes) -> None:
    import jax
    import jax.numpy as jnp

    from libzling_tpu import container
    from libzling_tpu.ops import entropy_kernel as ek
    from libzling_tpu.ops import relabel_kernel as rlk
    from libzling_tpu.ops import resolve_kernel as rk
    from libzling_tpu.ops import tokenize_kernel as tk
    from libzling_tpu.ops.mtf import initial_state
    from libzling_tpu.parallel import mesh as pmesh
    from libzling_tpu.tables import BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ

    i32 = jnp.int32
    chunks, sizes = container.parse(stream)
    C = len(chunks)
    max_chunks = BLOCK_SIZE_IN // (BLOCK_SIZE_ROLZ // 2) + 1
    _, out_bytes = rk.block_layout(sizes)
    words = len(ek.pack_payload_words(
        container.unpack_length_tables(chunks)[2])[0])
    r2s, s2r = initial_state()
    mesh = pmesh.make_mesh([dev])
    sds = jax.ShapeDtypeStruct
    progs = {
        "tokenize_block": lambda: tk.tokenize_block.lower(
            sds((BLOCK_SIZE_IN + tk.BLOCK_PAD,), jnp.uint8), sds((), i32),
            sds((max_chunks,), i32), sds((), i32), max_chunks=max_chunks,
            chunk_units=BLOCK_SIZE_ROLZ, interpret=False),
        "relabel_sorted": lambda: rlk.relabel_sorted.lower(
            r2s, s2r, sds((max_chunks * BLOCK_SIZE_ROLZ,), i32),
            sds((256,), i32), sds((256,), i32), sds((1,), i32),
            interpret=False),
        "build_chunk_tables": lambda: ek.build_chunk_tables.lower(
            sds((C, 514), i32), sds((C, 32), i32), sds((C,), i32),
            sds((C,), i32), sds((C,), i32)),
        "entropy_decode": lambda: ek.decode_tables.lower(
            sds((C, ek.META), i32), sds((C, 1024), i32), sds((C, 4096), i32),
            sds((C, 256), i32), sds((words,), i32), interpret=False),
        "resolve": lambda: rk._resolve_call.lower(
            sds((C, ek.MAX_TOKENS + 2), i32), sds((C, 4), i32),
            sds((65536,), i32), out_bytes=out_bytes, interpret=False),
        "parallel_encode_step": lambda: pmesh.parallel_encode_step.lower(
            sds((1, BLOCK_SIZE_IN + tk.BLOCK_PAD), jnp.uint8), sds((1,), i32),
            sds((1, max_chunks), i32), r2s, s2r, mesh=mesh,
            max_tokens=BLOCK_SIZE_ROLZ, max_chunks=max_chunks,
            chunk_units=BLOCK_SIZE_ROLZ, interpret=False),
    }
    for name, lower in progs.items():
        compiled, dt = _timed(lambda: lower().compile())
        print(f"[compile] {name}: {dt:.2f} s; {_memory(compiled)}",
              flush=True)


def kernel_phase(data: bytes, stream_e0: bytes) -> None:
    import jax.numpy as jnp
    import numpy as np

    from libzling_tpu import api, container, spec
    from libzling_tpu.native import engine
    from libzling_tpu.ops import entropy_kernel as ek
    from libzling_tpu.ops import mtf as mops
    from libzling_tpu.ops import relabel_kernel as rlk
    from libzling_tpu.ops import tokenize_kernel as tk
    from libzling_tpu.tables import BLOCK_SIZE_IN

    # entropy decode of one full chunk against the executable spec
    chunks, _ = container.parse(stream_e0)
    ch = max(chunks, key=lambda c: c.rlen)
    assert ch.rlen >= 262142, f"no full chunk in the stream ({ch.rlen})"
    len1, len2, bodies, rlens = container.unpack_length_tables([ch])
    (tokens, status), dt = _timed(lambda: ek.decode_chunks(
        len1, len2, bodies, rlens, interpret=False))
    status = np.asarray(status)
    want = spec.huffman_decode_chunk(ch.payload, ch.rlen)
    assert not status[0, 2] and status[0, 0] == ch.rlen, status[0]
    assert np.asarray(tokens)[0, :ch.rlen].tolist() == want, \
        "entropy kernel != spec.huffman_decode_chunk"
    print(f"[kernels] entropy decode of a {ch.rlen}-token chunk == spec "
          f"({dt:.2f} s incl. compile)", flush=True)

    # MTF relabel of a real block's literals against the sequential oracle
    block = data[:BLOCK_SIZE_IN]
    buf = np.zeros(len(block) + tk.BLOCK_PAD, np.uint8)
    buf[:len(block)] = np.frombuffer(block, np.uint8)
    units, stat = tk.tokenize_block(
        jnp.asarray(buf), jnp.int32(len(block)), jnp.zeros(129, jnp.int32),
        jnp.int32(262144), max_chunks=129, chunk_units=262144,
        interpret=False)
    sym, kind, _idx, ctx = (np.asarray(a) for a in tk.unpack_units(units))
    stat = np.asarray(stat)
    valid = np.arange(units.shape[1])[None, :] < stat[:129, 0][:, None]
    lit = valid & (kind == tk.KIND_LITERAL)
    n = 300_000
    lit_ctx, lit_raw = ctx[lit][:n], sym[lit][:n]
    r2s, s2r = mops.initial_state()
    got, r2s_k, s2r_k = rlk.encode_relabel(
        r2s, s2r, jnp.asarray(lit_ctx), jnp.asarray(lit_raw),
        jnp.ones(len(lit_ctx), bool), interpret=False)
    want, r2s_w, s2r_w = mops.encode_relabel_reference(r2s, s2r, lit_ctx,
                                                       lit_raw)
    assert np.asarray(got).tolist() == want.tolist(), "relabel != oracle"
    assert (np.asarray(r2s_k) == r2s_w).all() and \
        (np.asarray(s2r_k) == s2r_w).all(), "relabel state != oracle"
    print(f"[kernels] MTF relabel of {len(lit_ctx)} literals of a 16 MB "
          f"block == mtf.encode_relabel_reference", flush=True)

    # one 16 MB block through the device encode against the native engine
    got, dt = _timed(lambda: api.encode(block, 0, backend="device"))
    assert got == engine.encode(block, 0), "device block stream != native"
    print(f"[kernels] 16 MB block e0: device stream == native engine "
          f"({len(got)} bytes, {dt:.2f} s incl. compile)", flush=True)


def end_to_end(data: bytes, streams: dict, card: str) -> None:
    from libzling_tpu import api

    mb = len(data) / 1e6
    for level, native in streams.items():
        enc, cold = _timed(lambda: api.encode(data, level, backend="device"))
        assert enc == native, f"e{level}: device stream != native stream"
        enc, warm = _timed(lambda: api.encode(data, level, backend="device"))
        assert enc == native
        print(f"[e2e] e{level} encode device == native ({len(enc)} bytes); "
              f"smoke timing on {card}: first call {cold:.2f} s, warm "
              f"{warm:.2f} s = {mb / warm:.2f} MB/s", flush=True)
        out, cold = _timed(lambda: api.decode(enc, backend="device"))
        assert out == data, f"e{level}: device decode of the device stream " \
            "!= input"
        out, warm = _timed(lambda: api.decode(enc, backend="device"))
        assert out == data
        print(f"[e2e] e{level} decode backend=device of the device stream == "
              f"input; smoke timing on {card}: first call {cold:.2f} s, warm "
              f"{warm:.2f} s = {mb / warm:.2f} MB/s", flush=True)
        # "jax" is another name for "device"; the native stream is checked
        # as its own bytes even though it equals the device stream
        assert api.decode(native, backend="device") == data, \
            f"e{level}: device decode of the native stream != input"
        assert api.decode(enc, backend="jax") == data, \
            f"e{level}: jax decode != input"
        print(f"[e2e] e{level} decode backend=device of the native stream "
              f"and backend=jax of the device stream == input", flush=True)


def four_cards(data: bytes, streams: dict, devices, card: str) -> None:
    from libzling_tpu.parallel import decode_mesh
    from libzling_tpu.parallel import mesh as pmesh

    mb = len(data) / 1e6
    mesh4 = pmesh.make_mesh(devices)
    mesh1 = pmesh.make_mesh(devices[:1])
    for level, native in streams.items():
        enc, cold = _timed(lambda: pmesh.mesh_encode(data, level, mesh=mesh4))
        assert enc == native, f"e{level}: 4-card stream != native stream"
        enc, warm = _timed(lambda: pmesh.mesh_encode(data, level, mesh=mesh4))
        assert enc == native
        print(f"[4 cards] e{level} mesh_encode == native ({len(enc)} bytes) "
              f"on {card}: first call {cold:.2f} s (incl. compile), warm "
              f"{warm:.2f} s = {mb / warm:.2f} MB/s", flush=True)
        for label, mesh in (("4 cards", mesh4), ("1 card", mesh1)):
            out, cold = _timed(lambda: decode_mesh.mesh_decode(native,
                                                               mesh=mesh))
            assert out == data, f"e{level}: {label} mesh_decode != input"
            out, warm = _timed(lambda: decode_mesh.mesh_decode(native,
                                                               mesh=mesh))
            assert out == data
            print(f"[{label}] e{level} mesh_decode == input on {card}: first "
                  f"call {cold:.2f} s (incl. compile), warm {warm:.2f} s = "
                  f"{mb / warm:.2f} MB/s", flush=True)
    pmesh.mesh_encode(data[:16 * MB], 0, mesh=mesh1)  # compile
    enc, warm = _timed(lambda: pmesh.mesh_encode(data, 0, mesh=mesh1))
    assert enc == streams[0], "1-card stream != native stream"
    print(f"[1 card] e0 mesh_encode of the same {mb:.0f} MB on {card}: warm "
          f"{warm:.2f} s = {mb / warm:.2f} MB/s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    card, devices = identity(args.chips)

    from libzling_tpu.native import engine
    from libzling_tpu.ops import route
    from make_corpus import make_corpus

    route.init_compile_cache()
    size = (128 if args.chips == 4 else 32) * MB
    data, dt = _timed(lambda: make_corpus(size, SEED))
    streams = {level: engine.encode(data, level) for level in (0, 4)}
    print(f"[data] {size // MB} MB generated text (seed {SEED}) in "
          f"{dt:.2f} s; native streams: "
          + ", ".join(f"e{k} {len(v)} bytes" for k, v in streams.items()),
          flush=True)

    if args.chips == 4:
        four_cards(data, streams, devices, card)
    else:
        compile_phase(devices[0], streams[0])
        kernel_phase(data, streams[0])
        end_to_end(data, streams, card)

    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
