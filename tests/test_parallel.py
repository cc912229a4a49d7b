"""Multi-device block-DP encode on the virtual 8-device CPU mesh."""

import os

import numpy as np
import pytest
import jax

from libzling_tpu import spec
from libzling_tpu.parallel import mesh as pmesh

from .conftest import ref_decode
from .test_spec_vs_reference import _mixed_blob


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_mesh_encode_roundtrip(reference_binary):
    mesh = pmesh.make_mesh()
    data = _mixed_blob(40000, seed=21)
    stream = pmesh.mesh_encode(data, level=1, mesh=mesh, block_size=4096)
    # format-valid: decodable by the spec AND by the reference binary
    assert spec.decode(stream) == data
    assert ref_decode(reference_binary, stream) == data


def test_mesh_encode_mtf_carry(reference_binary):
    # blocks share MTF state: same content in later blocks must code
    # differently than a fresh-state encode would (i.e. carry is real),
    # and the reference must still decode it
    mesh = pmesh.make_mesh()
    data = (b"abcdefgh" * 1024)[:6000] * 3
    stream = pmesh.mesh_encode(data, level=0, mesh=mesh, block_size=2048)
    assert spec.decode(stream) == data
    assert ref_decode(reference_binary, stream) == data


def test_mesh_encode_equals_spec_bytes():
    # the DP encoder must reproduce the CANONICAL stream byte-for-byte at
    # equal geometry: multi-chunk blocks, adaptive level drop, MTF carry,
    # cross-block level carry (VERDICT round-1 item 4)
    rng = np.random.default_rng(9)
    data = (
        (b"the quick brown fox jumps over the lazy dog. " * 120)  # text
        + bytes(rng.integers(0, 256, 6000, dtype=np.uint8))       # level drop
        + (b"abcdefgh" * 600)                                     # recovery
    )
    mesh = pmesh.make_mesh()
    stream = pmesh.mesh_encode(data, level=2, mesh=mesh,
                               block_size=3000, max_tokens=700)
    ref = spec.encode(data, level=2, block_size=3000, max_tokens=700)
    assert stream == ref
    assert spec.decode(stream) == data


def test_mesh_encode_equals_spec_level0_carry():
    # carried level-0 across a group boundary (mispredict path)
    rng = np.random.default_rng(17)
    data = bytes(rng.integers(0, 256, 40000, dtype=np.uint8)) \
        + (b"zling " * 2000)
    mesh = pmesh.make_mesh()
    # same geometry as the test above so the jitted steps are cache hits
    stream = pmesh.mesh_encode(data, level=1, mesh=mesh,
                               block_size=3000, max_tokens=700)
    ref = spec.encode(data, level=1, block_size=3000, max_tokens=700)
    assert stream == ref


def test_mesh_adaptive_mispredict_passes():
    # adversarial D=8 group: alternating compressible/incompressible blocks
    # force the optimistic schedule to mispredict (the drop fires mid-group,
    # src/libzling.cpp:261-266); must converge to canonical bytes within a
    # bounded number of validation passes, surfaced as a counter
    from libzling_tpu.utils import metrics

    rng = np.random.default_rng(9)
    blocks = [(b"the quick brown fox jumps over " * 40)[:1024] if i % 2 == 0
              else bytes(rng.integers(0, 256, 1024, dtype=np.uint8))
              for i in range(8)]
    data = b"".join(blocks)
    mesh = pmesh.make_mesh()
    metrics.registry.reset()
    stream = pmesh.mesh_encode(data, level=1, mesh=mesh, block_size=1024,
                               max_tokens=400)
    assert stream == spec.encode(data, level=1, block_size=1024,
                                 max_tokens=400)
    passes = metrics.registry.snapshot()["counters"].get(
        "enc.schedule_mispredicts", 0)
    assert passes >= 1, "the adversarial group must actually mispredict"
    assert passes <= 8, f"validation did not converge quickly ({passes})"


def test_graft_entry_single_chip():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert int(out[3]) == int(args[1])  # consumed the whole input


def test_graft_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@pytest.mark.slow
@pytest.mark.skipif(not os.environ.get("ZLT_FULL_DRYRUN"),
                    reason="many minutes on the CPU; run with ZLT_FULL_DRYRUN=1")
def test_graft_dryrun_multichip_full_geometry():
    # the 64 KB-block geometry the driver gate doesn't run (advisor round 4):
    # the opt-in registered entry point for the larger-lane coverage
    import __graft_entry__ as ge

    ge.dryrun_multichip(8, full=True)


def test_mesh_decode_multidevice():
    # sharded entropy decode over the mesh + pipelined resolve with MTF
    # carry between block groups (parallel/decode_mesh.py), against the
    # executable spec on a multi-block multi-chunk stream
    import jax
    import numpy as np

    from libzling_tpu import spec
    from libzling_tpu.parallel import decode_mesh, mesh as pmesh

    rng = np.random.default_rng(41)
    data = (b"mesh decode pipeline " * 150
            + bytes(rng.integers(0, 256, 1500, dtype=np.uint8))) * 2
    stream = spec.encode(data, level=1, block_size=2048, max_tokens=500)
    mesh = pmesh.make_mesh(np.asarray(jax.devices()[:8]))
    small = dict(max_tokens=512)
    for gb in (1, 3):
        out = decode_mesh.mesh_decode(stream, mesh=mesh, group_blocks=gb,
                                      **small)
        assert out == data

    # empty input block (0x00 flag alone) before real blocks: the group
    # structure must skip it without desyncing block ids or output bases
    crafted = b"\x00" + stream
    assert decode_mesh.mesh_decode(crafted, mesh=mesh, group_blocks=1,
                                   **small) == spec.decode(crafted)

    # corrupt payload must raise, not return garbage (offset 300 sits in
    # the first chunk's Huffman bits and is spec-verified detectable; table
    # -region flips can be benign, and the format has no checksum)
    bad = bytearray(stream)
    bad[300] ^= 0xFF
    import pytest

    with pytest.raises(ValueError):
        decode_mesh.mesh_decode(bytes(bad), mesh=mesh, group_blocks=2,
                                **small)
