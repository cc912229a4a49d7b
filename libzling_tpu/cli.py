"""Command-line interface, mirroring the reference demo (demo/zling.cpp).

    python -m libzling_tpu e[0-6] [source [target]]   compress (default e0)
    python -m libzling_tpu d      [source [target]]   decompress

Defaults to stdin/stdout like the reference (demo/zling.cpp:176-192).  Like
the reference demo's main loop (demo/zling.cpp:117-151), the default path
STREAMS: input is consumed in block groups through
``utils.io.stream_encode``/``stream_decode`` at O(group) memory, with
per-16 MB-block progress on stderr (DemoActionHandler analog) -- a file
larger than RAM round-trips.  Extra flags: ``--backend`` picks
spec / native / pipeline / jax / device / mesh / auto (device backends need the
whole buffer and fall back to one-shot mode); ``--checksum`` prints the
adler32 of the uncompressed payload, computed incrementally.
"""

from __future__ import annotations

import sys
import time
import zlib

from .api import streams_by_default
from .utils.io import CodecHooks, FileSink, FileSource, stream_decode, stream_encode

_USAGE = """\
usage: python -m libzling_tpu <command> [source [target]] [--backend B] [--checksum]
 commands:
  e, e0..e6   compress (level 0..4 match the reference; e5/e6 are deeper
              searches producing smaller, still reference-decodable streams)
  d           decompress
 backends: auto (default: streaming block-group pipeline), pipeline, native,
           spec, jax, device, mesh (device backends buffer the whole input)
"""

class _Adler32Source(FileSource):
    """FileSource that accumulates adler32 over everything read."""

    def __init__(self, f):
        super().__init__(f)
        self.adler = zlib.adler32(b"")

    def read(self, n: int) -> bytes:
        out = super().read(n)
        self.adler = zlib.adler32(out, self.adler)
        return out


class _Adler32Sink(FileSink):
    """FileSink that accumulates adler32 over everything written."""

    def __init__(self, f):
        super().__init__(f)
        self.adler = zlib.adler32(b"")

    def write(self, data: bytes) -> int:
        self.adler = zlib.adler32(data, self.adler)
        return super().write(data)


def _progress_hooks(verb: str) -> CodecHooks:
    """Per-block progress + final summary on stderr, like the reference
    demo's DemoActionHandler (demo/zling.cpp:74-113)."""

    def on_block(n_in: int, n_out: int) -> None:
        sys.stderr.write(f"\r{n_in} => {n_out}")
        sys.stderr.flush()

    def on_done(n_in: int, n_out: int, dt: float) -> None:
        mb = n_in / 1e6
        sys.stderr.write(
            f"\r{verb}: {n_in} => {n_out} bytes, "
            f"time={dt:.3f} sec, speed={mb / max(dt, 1e-9):.3f} MB/sec\n")

    return CodecHooks(on_block=on_block, on_done=on_done)


def _run_oneshot(cmd: str, src, dst, backend: str, checksum: bool) -> None:
    """Whole-buffer path for device backends (jax/device/mesh/spec/native)."""
    from . import api

    data = src.read()
    t0 = time.time()
    if cmd == "d":
        out = api.decode(data, backend=backend)
        verb = "decode"
    else:
        level = int(cmd[1]) if len(cmd) == 2 else 0
        out = api.encode(data, level, backend=backend)
        verb = "encode"
    dt = time.time() - t0
    dst.write(out)
    mb = len(data) / 1e6
    sys.stderr.write(
        f"{verb}: {len(data)} => {len(out)} bytes, "
        f"time={dt:.3f} sec, speed={mb / max(dt, 1e-9):.3f} MB/sec\n")
    if checksum:
        # both directions hash the UNCOMPRESSED payload so an encode's
        # checksum can be compared with the matching decode's
        plain = data if verb == "encode" else out
        sys.stderr.write(f"adler32: {zlib.adler32(plain):#010x}\n")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    backend = "auto"
    checksum = False
    if "--backend" in argv:
        i = argv.index("--backend")
        backend = argv[i + 1]
        del argv[i:i + 2]
    if "--checksum" in argv:
        checksum = True
        argv.remove("--checksum")
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(_USAGE)
        return 0 if argv else 1

    # validate the command BEFORE opening (and truncating) any target file
    cmd = argv[0]
    is_enc = cmd == "e" or (len(cmd) == 2 and cmd[0] == "e" and cmd[1] in "0123456")
    if not (is_enc or cmd == "d"):
        sys.stderr.write(_USAGE)
        return 1
    src = open(argv[1], "rb") if len(argv) > 1 else sys.stdin.buffer
    dst = open(argv[2], "wb") if len(argv) > 2 else sys.stdout.buffer

    try:
        # streaming only for block-group-carry backends, honoring the
        # LIBZLING_TPU_BACKEND override on "auto" (api.streams_by_default
        # is the single source of truth); device lanes run one-shot
        if not streams_by_default(backend):
            _run_oneshot(cmd, src, dst, backend, checksum)
            return 0
        # streaming default: block-group bounded memory, per-block progress
        if cmd == "d":
            source = FileSource(src)
            sink = _Adler32Sink(dst) if checksum else FileSink(dst)
            stream_decode(source, sink, hooks=_progress_hooks("decode"))
            adler = sink.adler if checksum else None
        else:
            level = int(cmd[1]) if len(cmd) == 2 else 0
            source = _Adler32Source(src) if checksum else FileSource(src)
            sink = FileSink(dst)
            stream_encode(source, sink, level, hooks=_progress_hooks("encode"))
            adler = source.adler if checksum else None
        if checksum:
            sys.stderr.write(f"adler32: {adler:#010x}\n")
        return 0
    except ValueError as e:
        sys.stderr.write(f"error: {e}\n")
        return 1
    finally:
        if src is not sys.stdin.buffer:
            src.close()
        if dst is not sys.stdout.buffer:
            dst.close()


if __name__ == "__main__":
    raise SystemExit(main())
