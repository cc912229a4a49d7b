"""Test harness configuration.

Tests run JAX on the CPU backend with 8 virtual devices so the multi-chip
sharding paths are exercised without a GPU, and the Pallas kernels run in
interpret mode there.  Tests marked ``gpu`` need a card: they skip on the
CPU and run on the GPU with ``LIBZLING_TEST_GPU=1`` (README).
The env vars must be set before jax is imported anywhere.
"""

import os
import pathlib
import subprocess

# Force the CPU unless LIBZLING_TEST_GPU=1 asks for the card.  jax may
# already be imported by pytest plugins before this conftest runs, so the
# platform is set via jax.config, not JAX_PLATFORMS.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
if "xla_cpu_collective_timeout_seconds" not in flags:
    # 8 virtual devices timeshare a few CPU cores: long shard_map stages can
    # hold a collective past the default CPU timeout, which aborts the
    # process
    flags += (" --xla_cpu_collective_timeout_seconds=7200"
              " --xla_cpu_collective_call_terminate_timeout_seconds=7200")
os.environ["XLA_FLAGS"] = flags.strip()
import jax  # noqa: E402

if not os.environ.get("LIBZLING_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

from libzling_tpu.ops import route  # noqa: E402

# kernels placed on the CPU devices run in Pallas interpret mode
route.allow_cpu_interpret()

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run with LIBZLING_TEST_GPU=1 on the card)")
    return devs[0]


@pytest.fixture(scope="session")
def reference_binary() -> pathlib.Path:
    """Build (once) and return the upstream reference CLI as a golden oracle."""
    path = REPO / "build" / "oracle" / "zling_ref"
    if not path.exists():
        if not pathlib.Path("/root/reference/src/libzling.cpp").exists():
            pytest.skip("reference sources not available")
        subprocess.run(["sh", str(REPO / "tools" / "build_reference.sh")], check=True,
                       capture_output=True)
    return path


def ref_encode(binary, data: bytes, level: int) -> bytes:
    r = subprocess.run([str(binary), f"e{level}"], input=data, capture_output=True, check=True)
    return r.stdout


def ref_decode(binary, data: bytes) -> bytes:
    r = subprocess.run([str(binary), "d"], input=data, capture_output=True, check=True)
    return r.stdout


@pytest.fixture(scope="session")
def corpus_text() -> bytes:
    """A deterministic ~1 MB mixed-text corpus built from repo files."""
    import random

    rng = random.Random(20260817)
    parts = []
    for p in sorted(REPO.glob("**/*.py"))[:40]:
        try:
            parts.append(p.read_bytes())
        except OSError:
            pass
    parts.append((REPO / "SURVEY.md").read_bytes())
    blob = b"\n".join(parts)
    while len(blob) < 1 << 20:
        blob += blob[: 1 << 18]
        blob += bytes(rng.randrange(256) for _ in range(512))
    return blob[: 1 << 20]
