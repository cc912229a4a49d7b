"""Every kernel lowers for CUDA on the CPU and passes Triton's IR verifier.

Interpret mode runs a kernel's semantics but not the GPU compiler's type
rules; lowering with ``lowering_platforms=("cuda",)`` builds the Triton IR
the card would compile, and the verifier rejects what the card would.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest

from libzling_tpu.ops import entropy_kernel as ek
from libzling_tpu.ops import relabel_kernel as rlk
from libzling_tpu.ops import resolve_kernel as rk
from libzling_tpu.ops import tokenize_kernel as tk

i32 = jnp.int32
sds = jax.ShapeDtypeStruct

KERNELS = {
    "entropy": (lambda *a: ek.decode_tables(*a, interpret=False),
                (sds((3, ek.META), i32), sds((3, 1024), i32),
                 sds((3, 4096), i32), sds((3, 256), i32),
                 sds((4096,), i32))),
    "resolve": (lambda *a: rk._resolve_call(*a, out_bytes=8192,
                                            interpret=False),
                (sds((3, 1026), i32), sds((3, 4), i32), sds((65536,), i32))),
    "tokenize": (lambda *a: tk.tokenize_block(*a, max_chunks=4,
                                              chunk_units=1024,
                                              interpret=False),
                 (sds((4096 + tk.BLOCK_PAD,), jnp.uint8), sds((), i32),
                  sds((4,), i32), sds((), i32))),
    "relabel": (lambda *a: rlk.relabel_sorted(*a, interpret=False),
                (sds((256, 256), i32), sds((256, 256), i32),
                 sds((4096,), i32), sds((256,), i32), sds((256,), i32),
                 sds((1,), i32))),
}


@pytest.fixture
def verified_modules(monkeypatch):
    """Run the MLIR verifier on every Triton module the lowering builds."""
    from jax._src.pallas.triton import lowering

    built = []
    lower = lowering.lower_jaxpr_to_triton_module

    def verify(*args, **kwargs):
        result = lower(*args, **kwargs)
        result.module.operation.verify()
        built.append(result.module)
        return result

    monkeypatch.setattr(lowering, "lower_jaxpr_to_triton_module", verify)
    return built


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_lowers_for_cuda(name, verified_modules):
    fn, args = KERNELS[name]
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert verified_modules, "no Triton module was built"
    assert "triton" in text
