"""Golden tests for the device backend (entropy + resolve kernels) and for
the choice of kernel route (ops/route.py).

Runs the Pallas kernels in interpret mode on the CPU backend; chip_smoke.py
checks the compiled kernels on the card.  Streams are built with the
executable spec's chunk primitives so multi-chunk blocks and multi-block MTF
carry are covered with KB-sized inputs (a real 262,143-token chunk is far
too slow to interpret).
"""

from __future__ import annotations

import numpy as np
import pytest

from libzling_tpu import device, spec
from libzling_tpu.ops import route
from libzling_tpu.tables import SENTINEL_LEN


def _make_stream(pieces, level=1, max_tokens=300) -> bytes:
    """Frame each piece as one input_block, chunks capped at max_tokens.

    Small blocks/chunks are format-valid (the reference decoder accepts any
    encpos splits); the MTF tables carry across blocks exactly as in the
    full-size stream (SURVEY.md section 0.3).
    """
    enc = spec.RolzEncoder()
    out = bytearray()
    for piece in pieces:
        buf = bytearray(piece) + bytearray(SENTINEL_LEN)
        ilen = len(piece)
        enc.reset()
        pos = 0
        while pos < ilen:
            tokens, pos = enc.encode_chunk(level, buf, ilen, pos, max_tokens)
            payload = spec.huffman_encode_chunk(tokens)
            out.append(1)
            out.extend(pos.to_bytes(4, "big"))
            out.extend(len(tokens).to_bytes(4, "big"))
            out.extend(len(payload).to_bytes(4, "big"))
            out.extend(payload)
        out.append(0)
    return bytes(out)


def test_multichunk_multiblock_roundtrip():
    rng = np.random.default_rng(5)
    pieces = [
        (b"the quick brown fox jumps over the lazy dog. " * 60),
        b"ab" * 700 + b"X" * 300,                      # overlap copies
        bytes(rng.integers(0, 256, 1200, dtype=np.uint8)),  # literals
        (b"zlQ" * 500) + b"the quick brown fox",       # word-MRU heavy
    ]
    stream = _make_stream(pieces, level=1, max_tokens=300)
    data = b"".join(pieces)
    assert spec.decode(stream) == data  # the stream itself is conforming
    got = device.decode(stream)
    assert got == data


def test_single_long_match_chain():
    # long runs produce max-length (259-byte) overlapping matches
    data = b"A" * 900 + b"B" + b"A" * 900 + b"xyz" * 200
    stream = _make_stream([data], level=0, max_tokens=4000)
    assert spec.decode(stream) == data
    assert device.decode(stream) == data


def test_real_spec_stream():
    # a stream produced by the unmodified spec encoder (single chunk)
    data = (b"compression is the art of prediction " * 40)[:1400]
    stream = spec.encode(data, level=2)
    assert device.decode(stream) == data


def _craft_raw_chunk(tokens, encpos):
    payload = spec.huffman_encode_chunk(tokens)
    out = bytearray([1])
    out.extend(encpos.to_bytes(4, "big"))
    out.extend(len(tokens).to_bytes(4, "big"))
    out.extend(len(payload).to_bytes(4, "big"))
    out.extend(payload)
    out.append(0)
    return bytes(out)


def test_rejects_matchidx_zero():
    # self-copy (idx 0) hangs the reference decoder; ours must reject
    stream = _craft_raw_chunk([65, 66, 258, 0], 6)
    with pytest.raises(ValueError):
        device.decode(stream)


def test_rejects_never_written_ring_slot():
    # idx points at a ring slot no token ever wrote -> src == 0
    stream = _craft_raw_chunk([65, 66, 67, 258, 9], 7)
    with pytest.raises(ValueError):
        device.decode(stream)


def test_rejects_encpos_mismatch():
    stream = _craft_raw_chunk([65, 66, 67], 9)  # claims 9, decodes 3
    with pytest.raises(ValueError):
        device.decode(stream)


def test_api_device_backend_roundtrip():
    # the "device" backend through the public API (decode via both kernels)
    import libzling_tpu as z

    data = (b"public api device backend " * 50)[:1000]
    stream = z.encode(data, 1)
    assert z.decode(stream, backend="device") == data


def test_api_device_backend_encode():
    # encode(backend="device"): the tokenizer kernel on a 1-device mesh at
    # canonical geometry produces the canonical stream (interpreted on CPU)
    import libzling_tpu as z

    rng = np.random.default_rng(5)
    data = (b"device encode lane through the public api " * 40
            + bytes(rng.integers(0, 256, 500, dtype=np.uint8)))
    stream = z.encode(data, 0, backend="device")
    assert stream == spec.encode(data, 0)
    assert z.decode(stream, backend="device") == data


def test_split_decode_multiblock_mtf_carry():
    # the MTF table carries across blocks while ring and heads reset: the
    # same text in later blocks codes differently than a fresh encode
    rng = np.random.default_rng(31)
    piece = b"split decode pass " * 80 + bytes(rng.integers(0, 256, 300,
                                                          dtype=np.uint8))
    pieces = [piece, piece[::-1], piece]
    stream = _make_stream(pieces, level=2, max_tokens=250)
    fresh = _make_stream([piece], level=2, max_tokens=250)
    assert stream[-len(fresh):] != fresh
    assert device.decode(stream) == b"".join(pieces)


def test_split_decode_rejects_corrupt():
    # a corrupt chunk in a later block: the chunk's bad flag must surface
    good = _make_stream([b"first block is fine " * 30], level=1)
    bad = _craft_raw_chunk([65, 66, 67, 258, 9], 7)
    with pytest.raises(ValueError):
        device.decode(good + bad)


def _truncated_payload_stream() -> bytes:
    # a good block, then a block whose chunk payload lost its second half:
    # the entropy kernel stops early and leaves token slots unwritten
    good = _make_stream([b"first block is fine " * 30], level=1)
    data = b"the payload of this chunk is cut in half " * 40
    enc = spec.RolzEncoder()
    enc.reset()
    tokens, encpos = enc.encode_chunk(1, bytearray(data) + bytearray(
        SENTINEL_LEN), len(data), 0)
    cut = spec.huffman_encode_chunk(tokens)[:-200]
    out = bytearray(good) + bytearray([1])
    for v in (encpos, len(tokens), len(cut)):
        out.extend(v.to_bytes(4, "big"))
    return bytes(out + cut + bytes([0]))


@pytest.mark.parametrize("backend", ["device", "mesh"])
def test_rejects_truncated_payload(backend):
    import libzling_tpu as z

    with pytest.raises(ValueError, match="corrupt"):
        z.decode(_truncated_payload_stream(), backend=backend)


class _FakeDevice:
    def __init__(self, platform, kind):
        self.platform, self.device_kind = platform, kind


def test_route_compiles_on_gpu():
    assert route.interpret_mode(_FakeDevice("gpu", "NVIDIA H100")) is False


def test_route_interprets_on_cpu_only_on_request():
    cpu = _FakeDevice("cpu", "cpu")
    assert route.interpret_mode(cpu) is True  # conftest asked for it
    route.allow_cpu_interpret(False)
    try:
        with pytest.raises(RuntimeError, match="platform='cpu'"):
            route.interpret_mode(cpu)
    finally:
        route.allow_cpu_interpret()


def test_route_raises_elsewhere():
    with pytest.raises(RuntimeError, match="platform='metal'.*'Apple M2'"):
        route.interpret_mode(_FakeDevice("metal", "Apple M2"))


@pytest.mark.gpu
@pytest.mark.parametrize("level", [0, 4])
def test_device_path_compiled_on_gpu(gpu, level):
    # on the card: the compiled kernels reproduce the native engine's stream
    # and decode it back through both device backends
    import libzling_tpu as z
    from libzling_tpu.native import engine

    rng = np.random.default_rng(level)
    words = [b"zling ", b"device ", b"stream ", b"the ", b"of ", b"\n"]
    data = b"".join(words[i] for i in rng.integers(0, 6, 60000)) \
        + bytes(rng.integers(0, 256, 20000, dtype=np.uint8))
    stream = z.encode(data, level, backend="device")
    assert stream == engine.encode(data, level)
    assert z.decode(stream, backend="device") == data
    assert z.decode(stream, backend="jax") == data


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["device", "mesh"])
def test_rejects_truncated_payload_on_gpu(gpu, backend):
    # on the card the unwritten token slots are not zeroed: resolve must
    # still stay inside its tables and report the corrupt chunk
    import libzling_tpu as z

    for _ in range(3):
        with pytest.raises(ValueError, match="corrupt"):
            z.decode(_truncated_payload_stream(), backend=backend)
