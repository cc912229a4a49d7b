"""Public codec API with pluggable backends.

Backends:
  "spec"   -- pure-Python executable specification (slow, always available)
  "native" -- C++ host engine (block-parallel, bit-exact)
  "device" -- the codec on one GPU: encode via the tokenizer kernel on a
              single-device mesh, decode via the entropy kernel then the
              resolve kernel block by block with the MTF table carried on
              the card (libzling_tpu.device; canonical 16 MB geometry)
  "jax"    -- another name for "device" (libzling_tpu.codec)
  "mesh"   -- every local GPU: block-DP encode (parallel.mesh) and
              sharded-entropy pipelined decode (parallel.decode_mesh);
              canonical byte-identical streams
  "auto"   -- fastest available: native for host calls; use the
              ``libzling_tpu.codec`` module directly for device pipelines.
"""

from __future__ import annotations

import os
from typing import Callable

from . import spec

_BACKENDS_ENC: dict[str, Callable[[bytes, int], bytes]] = {}
_BACKENDS_DEC: dict[str, Callable[[bytes], bytes]] = {}


def _register_backends() -> None:
    _BACKENDS_ENC["spec"] = lambda d, lvl: spec.encode(d, lvl)
    _BACKENDS_DEC["spec"] = spec.decode
    try:
        from .native import engine as _native

        _BACKENDS_ENC["native"] = _native.encode
        _BACKENDS_DEC["native"] = _native.decode
    except Exception:  # pragma: no cover - native build unavailable
        pass
    try:
        from . import pipeline as _pipeline

        _BACKENDS_ENC["pipeline"] = _pipeline.encode
        _BACKENDS_DEC["pipeline"] = _pipeline.decode
    except Exception:  # pragma: no cover - native build unavailable
        pass

    # device backends import jax (seconds of import time and hundreds of MB
    # of RSS): register them lazily so host-only calls and the CLI never
    # pay for them
    def _enc_jax(d, lvl):
        from . import codec as _jax_codec

        return _jax_codec.encode(d, lvl)

    def _dec_jax(d):
        from . import codec as _jax_codec

        return _jax_codec.decode(d)

    def _enc_device(d, lvl):
        from . import device as _device

        return _device.encode(d, lvl)

    def _dec_device(d):
        from . import device as _device

        return _device.decode(d)

    def _enc_mesh(d, lvl):
        # multi-chip lane: encode block-DP over the default mesh
        from .parallel import mesh as _pmesh

        return _pmesh.mesh_encode(d, lvl)

    def _dec_mesh(d):
        # per-chunk entropy sharded over the default mesh (decode_mesh.py)
        from .parallel import decode_mesh as _dmesh

        return _dmesh.mesh_decode(d)

    _BACKENDS_ENC["jax"] = _enc_jax
    _BACKENDS_DEC["jax"] = _dec_jax
    _BACKENDS_ENC["device"] = _enc_device
    _BACKENDS_DEC["device"] = _dec_device
    _BACKENDS_ENC["mesh"] = _enc_mesh
    _BACKENDS_DEC["mesh"] = _dec_mesh


_register_backends()


def _resolve(table: dict[str, Callable], backend: str) -> Callable:
    if backend == "auto":
        backend = os.environ.get("LIBZLING_TPU_BACKEND", "")
        if not backend:
            for name in ("pipeline", "native", "spec"):
                if name in table:
                    backend = name
                    break
    if backend not in table:
        raise ValueError(f"backend {backend!r} unavailable; have {sorted(table)}")
    return table[backend]


def encode(data: bytes, level: int = 0, backend: str = "auto") -> bytes:
    """Compress ``data`` into a zling-format stream at level 0..4."""
    return _resolve(_BACKENDS_ENC, backend)(bytes(data), level)


def decode(data: bytes, backend: str = "auto") -> bytes:
    """Decompress a zling-format stream."""
    return _resolve(_BACKENDS_DEC, backend)(bytes(data))


# backends with a block-group carry API stream at O(group) memory
# (utils/io.py); the device lanes need the whole buffer resident
_STREAMING = ("auto", "pipeline")


def effective_backend(backend: str) -> str:
    """Apply the LIBZLING_TPU_BACKEND override to 'auto' (the same rule
    _resolve uses), so streaming-vs-buffering decisions see the user's
    pinned backend -- the single source of truth for the CLI too."""
    if backend == "auto":
        return os.environ.get("LIBZLING_TPU_BACKEND", "") or "auto"
    return backend


def streams_by_default(backend: str) -> bool:
    """True when this backend routes through the block-group streaming
    pipeline (O(group) memory) rather than buffering the whole input."""
    return effective_backend(backend) in _STREAMING


def encode_file(src: str, dst: str, level: int = 0, backend: str = "auto") -> tuple[int, int]:
    """Compress file ``src`` to ``dst``; returns (bytes_in, bytes_out).

    The default backend streams in block groups (O(group) memory, like the
    reference demo's 16 MB-block loop, demo/zling.cpp:117-151), so files
    larger than RAM work; device backends buffer the whole file.
    """
    from .utils.io import FileSink, FileSource, stream_encode

    with open(src, "rb") as fin, open(dst, "wb") as fout:
        if streams_by_default(backend):
            return stream_encode(FileSource(fin), FileSink(fout), level)
        data = fin.read()
        out = encode(data, level, backend)
        fout.write(out)
    return len(data), len(out)


def decode_file(src: str, dst: str, backend: str = "auto") -> tuple[int, int]:
    """Decompress file ``src`` to ``dst``; returns (bytes_in, bytes_out).

    Streams in block groups on the default backend (see ``encode_file``).
    """
    from .utils.io import FileSink, FileSource, stream_decode

    with open(src, "rb") as fin, open(dst, "wb") as fout:
        if streams_by_default(backend):
            return stream_decode(FileSource(fin), FileSink(fout))
        data = fin.read()
        out = decode(data, backend)
        fout.write(out)
    return len(data), len(out)
