"""libzling_tpu: a lossless codec implementing the zling format.

The zling bitstream format (order-1 ROLZ + two-alphabet canonical Huffman,
richox/libzling) re-built from scratch: a native C++ engine for the host
path, JAX with Pallas kernels for the GPU path, and jax.sharding
block-data-parallelism across cards.

Public API (mirrors the reference's two-function surface, src/libzling.h:44-45):

    encode(data, level=0, backend="auto") -> bytes
    decode(data, backend="auto")          -> bytes
    encode_file(src, dst, level=0), decode_file(src, dst)
"""

from .api import decode, decode_file, encode, encode_file  # noqa: F401

__version__ = "0.1.0"

__all__ = ["encode", "decode", "encode_file", "decode_file", "__version__"]
