"""Round-trip fuzz harness (the test/fuzzy/libzling_fuzzy.py analog).

Random and adversarial blobs piped through encode->decode at ALL levels
(including e4, which the reference's own fuzzer skips), cross-checked against
the reference binary when available, plus corrupt-stream decode fuzzing (the
decoder must reject or cleanly round-trip -- never hang or crash).  Failure
artifacts dump to fuzzdump_<digest>/.

Usage: python tools/fuzz.py [--rounds N] [--max-size BYTES] [--seed S]
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import random
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# the device-kernel decode lanes below run the Pallas kernels in interpret
# mode on the CPU (virtual devices give the mesh lane several)
import os  # noqa: E402

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import libzling_tpu as z  # noqa: E402
from libzling_tpu.ops import route  # noqa: E402

route.allow_cpu_interpret()


def _blob(rng: random.Random, n: int) -> bytes:
    style = rng.random()
    if style < 0.25:
        return bytes(rng.randrange(256) for _ in range(n))
    if style < 0.5:
        words = [b"the ", b"of ", b"zling", b"\n", b"compress ", b"a"]
        out = bytearray()
        while len(out) < n:
            out += rng.choice(words)
        return bytes(out[:n])
    if style < 0.7:
        return bytes([rng.randrange(8)]) * n
    out = bytearray()
    while len(out) < n:
        if out and rng.random() < 0.5:
            s = rng.randrange(len(out))
            out += out[s:s + rng.randrange(1, 512)]
        else:
            out += bytes(rng.randrange(256) for _ in range(rng.randrange(1, 64)))
    return bytes(out[:n])


def _dump(tag: str, **artifacts: bytes) -> pathlib.Path:
    d = REPO / f"fuzzdump_{tag}"
    d.mkdir(exist_ok=True)
    for name, blob in artifacts.items():
        (d / name).write_bytes(blob)
    return d


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--max-size", type=int, default=262144)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    ref = REPO / "build" / "oracle" / "zling_ref"
    rng = random.Random(args.seed)
    failures = 0
    for r in range(args.rounds):
        n = rng.randrange(0, args.max_size)
        data = _blob(rng, n)
        level = rng.randrange(7)  # 0-4 reference levels + e5/e6 extensions
        tag = hashlib.md5(data).hexdigest()[:12]
        try:
            stream = z.encode(data, level)
            back = z.decode(stream)
            assert back == data, "round-trip mismatch"
            if ref.exists():
                if level <= 4:
                    expect = subprocess.run(
                        [str(ref), f"e{level}"], input=data,
                        capture_output=True, timeout=120).stdout
                    assert stream == expect, "not bit-exact with reference"
                else:
                    # e5/e6 are framework levels: the reference cannot
                    # produce them but MUST be able to decode them
                    got = subprocess.run([str(ref), "d"], input=stream,
                                         capture_output=True,
                                         timeout=120).stdout
                    assert got == data, "reference cannot decode e5/e6 stream"
            # device-kernel decode lane (entropy + resolve kernels), in
            # interpret mode for small blobs: must agree byte-for-byte
            if n <= 3000:
                from libzling_tpu import device
                from libzling_tpu.parallel import decode_mesh, mesh as pmesh

                assert device.decode(stream) == data, \
                    "device-kernel decode mismatch"
                # sharded-entropy mesh decode lane on the same stream
                mout = decode_mesh.mesh_decode(
                    stream, mesh=pmesh.make_mesh(), group_blocks=2,
                    max_tokens=8192)
                assert mout == data, "mesh decode mismatch"
            # corrupt-stream decode: flip a random bit; must raise or produce
            # bytes, never hang (bounded by subprocess-free in-process call)
            if stream:
                bad = bytearray(stream)
                i = rng.randrange(len(bad))
                bad[i] ^= 1 << rng.randrange(8)
                try:
                    z.decode(bytes(bad))
                except ValueError:
                    pass
                if n <= 3000:
                    # same corrupt stream through the sharded mesh lane:
                    # must raise or produce bytes, never hang or crash
                    # (decode_mesh/pmesh already imported on this path)
                    try:
                        decode_mesh.mesh_decode(
                            bytes(bad), mesh=pmesh.make_mesh(), group_blocks=2,
                            max_tokens=8192)
                    except ValueError:
                        pass
        except Exception as e:  # noqa: BLE001
            failures += 1
            d = _dump(tag, input=data, error=str(e).encode())
            print(f"round {r}: FAIL ({e}) -> {d}", file=sys.stderr)
        if (r + 1) % 10 == 0:
            print(f"{r + 1}/{args.rounds} rounds, {failures} failures", file=sys.stderr)
    print("FAILED" if failures else "PASSED", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
