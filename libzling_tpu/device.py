"""The "device" backend: the whole codec on one GPU.

  encode: the single-device case of the block-parallel mesh encode at the
          canonical 16 MB / 262,143-token geometry (parallel/mesh.py):
          ROLZ tokenize, MTF relabel, histograms and bit-pack on the card;
          the host builds the exact Huffman length tables and the framing.
  decode: the single-device case of the mesh decode (parallel/decode_mesh.py),
          block by block:
          [host]   parse the container, nibble-unpack the length tables
          [device] entropy decode, one program per chunk
                   (ops/entropy_kernel.py)
          [device] the serial resolve chain over the block's chunks
                   (ops/resolve_kernel.py), the MTF table carried on the
                   card from block to block
          [host]   one fetch of the output bytes and statuses at the end

For reference-format streams the resolve chain is serial (contexts are
decoded content and the MTF table crosses blocks, DESIGN.md section 4), so
decode has one serial lane; entropy decode is parallel over chunks.  The
kernels compile for the GPU and raise elsewhere (ops/route.py); on the CPU
they run in interpret mode only on request, so keep such inputs small.
"""

from __future__ import annotations

import jax


def _one_device_mesh():
    from .parallel import mesh as pmesh

    return pmesh.make_mesh(jax.devices()[:1])


def encode(data: bytes, level: int = 0) -> bytes:
    """Encode on the device; byte-identical to ``spec.encode(data, level)``."""
    from .parallel import mesh as pmesh

    return pmesh.mesh_encode(data, level, mesh=_one_device_mesh())


def decode(data: bytes) -> bytes:
    """Decode a zling stream on the device.  Bit-exact with spec.decode;
    corrupt streams raise ValueError."""
    from .parallel import decode_mesh

    return decode_mesh.mesh_decode(data, mesh=_one_device_mesh())
