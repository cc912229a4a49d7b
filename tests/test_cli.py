"""CLI streaming tests: the user surface must process files larger than RAM.

The reference demo streams stdin->stdout in 16 MB blocks at O(block) memory
(demo/zling.cpp:117-151); our CLI streams in 64 MB block groups through
utils/io.py.  The big test below pushes a >3-group (200 MB) generated file
through the real ``python -m libzling_tpu`` subprocess both directions and
asserts the peak RSS stays group-bounded (far below the file size), i.e. the
CLI never slurps the input.
"""

from __future__ import annotations

import hashlib
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

# a 200 MB generated input is >3 block groups (64 MB each); the streaming
# path's working set is ~1 group + pooled token buffers (~390 MB measured,
# with ~10% run-to-run arena variance), while a slurped run needs
# data + encode_bound(data) + buffers (>550 MB)
_SIZE_MB = 200
_RSS_CAP_MB = 480


def _gen_input(path: pathlib.Path, mb: int) -> str:
    """Write ``mb`` MB of compressible-but-varied data; returns sha256."""
    h = hashlib.sha256()
    with open(path, "wb") as f:
        for i in range(mb):
            unit = (b"streaming cli coverage block %07d: "
                    b"the quick brown fox jumps over the lazy dog | " % i)
            chunk = (unit * ((1 << 20) // len(unit) + 1))[:1 << 20]
            f.write(chunk)
            h.update(chunk)
    return h.hexdigest()


def _run_cli_rss(args: list[str]) -> int:
    """Run the CLI in a fresh interpreter; returns its peak RSS in bytes."""
    code = (
        "import resource, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from libzling_tpu.cli import main\n"
        f"rc = main({args!r})\n"
        "print('MAXRSS_KB', resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)\n"
        "sys.exit(rc)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    for line in r.stdout.splitlines():
        if line.startswith("MAXRSS_KB"):
            return int(line.split()[1]) * 1024
    raise AssertionError(f"no MAXRSS in output: {r.stdout!r}\n{r.stderr}")


def _sha256_file(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 22)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


@pytest.mark.slow
def test_cli_streams_large_file_bounded_rss(tmp_path):
    src = tmp_path / "big.in"
    enc = tmp_path / "big.zlg"
    dec = tmp_path / "big.out"
    digest = _gen_input(src, _SIZE_MB)

    rss_enc = _run_cli_rss(["e1", str(src), str(enc)])
    assert rss_enc < _RSS_CAP_MB << 20, (
        f"encode peak RSS {rss_enc >> 20} MB — CLI is not streaming")
    assert enc.stat().st_size < _SIZE_MB << 20

    rss_dec = _run_cli_rss(["d", str(enc), str(dec)])
    assert rss_dec < _RSS_CAP_MB << 20, (
        f"decode peak RSS {rss_dec >> 20} MB — CLI is not streaming")

    assert dec.stat().st_size == _SIZE_MB << 20
    assert _sha256_file(dec) == digest

    # streaming must not change the bytes: the group-carry encode of the
    # first group equals the one-shot encode of the same prefix
    one_group = tmp_path / "g.in"
    with open(src, "rb") as f, open(one_group, "wb") as g:
        g.write(f.read(64 << 20))
    from libzling_tpu import pipeline

    with open(enc, "rb") as f:
        stream_prefix = f.read()
    oneshot = pipeline.encode(one_group.read_bytes(), 1)
    assert stream_prefix[:len(oneshot)] == oneshot


def test_cli_stdin_stdout_roundtrip():
    # the reference demo's default mode: stdin -> stdout both directions
    data = (b"stdin/stdout streaming roundtrip " * 2000
            + bytes(range(256)) * 40)
    r = subprocess.run(
        [sys.executable, "-m", "libzling_tpu", "e2", "--checksum"],
        input=data, capture_output=True, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    assert b"adler32:" in r.stderr
    r2 = subprocess.run(
        [sys.executable, "-m", "libzling_tpu", "d", "--checksum"],
        input=r.stdout, capture_output=True, cwd=str(REPO), timeout=300)
    assert r2.returncode == 0, r2.stderr.decode()
    assert r2.stdout == data
    # encode and decode print the SAME adler32 (of the uncompressed payload)
    a1 = [ln for ln in r.stderr.splitlines() if ln.startswith(b"adler32")]
    a2 = [ln for ln in r2.stderr.splitlines() if ln.startswith(b"adler32")]
    assert a1 == a2 and len(a1) == 1


def test_streams_by_default_honors_env_override(monkeypatch):
    # LIBZLING_TPU_BACKEND pins "auto": the streaming decision must see the
    # pinned backend (a device-backend validation run must not silently
    # exercise the host pipeline instead)
    from libzling_tpu import api

    monkeypatch.delenv("LIBZLING_TPU_BACKEND", raising=False)
    assert api.streams_by_default("auto")
    assert api.streams_by_default("pipeline")
    assert not api.streams_by_default("device")
    monkeypatch.setenv("LIBZLING_TPU_BACKEND", "spec")
    assert not api.streams_by_default("auto")
    monkeypatch.setenv("LIBZLING_TPU_BACKEND", "pipeline")
    assert api.streams_by_default("auto")


def test_cli_oneshot_backend_still_works(tmp_path):
    # non-streaming backends (spec here) keep the whole-buffer path
    data = b"one-shot backend path " * 300
    src = tmp_path / "s.in"
    src.write_bytes(data)
    enc = tmp_path / "s.zlg"
    r = subprocess.run(
        [sys.executable, "-m", "libzling_tpu", "e0", str(src), str(enc),
         "--backend", "spec"], capture_output=True, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    from libzling_tpu import pipeline

    assert pipeline.decode(enc.read_bytes()) == data
