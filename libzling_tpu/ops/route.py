"""Where and how the codec's Pallas kernels run.

Every kernel in ``libzling_tpu.ops`` is a Pallas kernel on the Triton route.
This module is the one place that decides how a kernel call runs:

  * on a device whose platform is ``gpu``: compiled by Triton;
  * on the CPU: in Pallas interpret mode, but only after the caller asked
    for it with ``allow_cpu_interpret()`` (tests, the fuzzer and the
    multi-device dry run do; interpret mode is for correctness, not speed);
  * anywhere else: ``RuntimeError`` naming the platform and device kind.

There is no fallback: a device path that finds no GPU raises instead of
quietly running the interpreter, the host engine or the CPU.
"""

from __future__ import annotations

import os
import pathlib

import jax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_cpu_interpret = False


def allow_cpu_interpret(allowed: bool = True) -> None:
    """Let kernels placed on the CPU run in Pallas interpret mode."""
    global _cpu_interpret
    _cpu_interpret = allowed


def _target_device(device=None):
    if device is not None:
        return device
    dev = jax.config.jax_default_device
    if isinstance(dev, str):
        return jax.devices(dev)[0]
    return dev if dev is not None else jax.devices()[0]


def interpret_mode(device=None) -> bool:
    """True to interpret, False to compile the kernels placed on ``device``
    (default: the device a computation would land on); raises where no
    route exists."""
    dev = _target_device(device)
    platform = getattr(dev, "platform", None)
    if platform == "gpu":
        return False
    if platform == "cpu" and _cpu_interpret:
        return True
    hint = (" (interpret mode on the CPU needs "
            "libzling_tpu.ops.route.allow_cpu_interpret())"
            if platform == "cpu" else "")
    raise RuntimeError(
        f"zling: no compiled kernel route for platform={platform!r} "
        f"device_kind={getattr(dev, 'device_kind', None)!r}{hint}")


def pallas_call(kernel, *, interpret: bool, **kwargs):
    """``pl.pallas_call`` on the Triton route (whole-array refs).

    One warp per program: every kernel runs a serial chain of dependent
    steps, and its few vector operations (at most 512 lanes) fit a warp."""
    return pl.pallas_call(
        kernel, backend="triton", interpret=interpret,
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        **kwargs)


def barrier(interpret: bool) -> None:
    """Make this program's global-memory writes visible to all its threads
    (a no-op in interpret mode, where one thread runs the program)."""
    if not interpret:
        pltriton.debug_barrier()


def init_compile_cache() -> None:
    """Keep JAX's persistent compile cache where JAX_COMPILATION_CACHE_DIR
    says, or else in ``<repo>/build/jaxcache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # JAX reads the variable itself
    if jax.config.jax_compilation_cache_dir:
        return
    repo = pathlib.Path(__file__).resolve().parents[2]
    jax.config.update("jax_compilation_cache_dir",
                      str(repo / "build" / "jaxcache"))
