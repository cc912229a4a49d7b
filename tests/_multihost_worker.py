"""Worker process for the 2-process jax.distributed CPU simulation.

Launched by tests/test_multihost.py:
    python _multihost_worker.py <coordinator> <num_procs> <proc_id> <outfile>

Each process owns 4 virtual CPU devices (8 global); mesh_encode runs over
the global mesh with process_allgather-based host gathers, and every process
must assemble the identical canonical stream (SURVEY.md section 4:
multi-process simulation before pod runs).
"""

import os
import pathlib
import sys

coordinator, num_procs, proc_id, outfile = sys.argv[1:5]

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from libzling_tpu import spec  # noqa: E402
from libzling_tpu.ops import route  # noqa: E402
from libzling_tpu.parallel import distributed as dist  # noqa: E402

route.allow_cpu_interpret()
# the 2x4-device shard_map compile dominates this worker's runtime;
# cached, the whole test is seconds
route.init_compile_cache()

assert dist.init_distributed(coordinator, num_procs, proc_id)

assert jax.process_count() == int(num_procs)
assert len(jax.devices()) == 4 * int(num_procs)

rng = np.random.default_rng(23)
data = ((b"distributed zling over two processes " * 80)
        + bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
        + (b"tail text recovers the level " * 40))

stream = dist.distributed_encode(data, level=1, block_size=2048,
                                 max_tokens=500, elastic=True)
canonical = spec.encode(data, level=1, block_size=2048, max_tokens=500)
assert stream == canonical, (
    f"proc {proc_id}: mesh stream != canonical ({len(stream)} vs {len(canonical)})")
assert spec.decode(stream) == data

# decode direction: entropy sharded over both processes' devices, resolve
# replicated -- every process must reconstruct the identical input bytes
out = dist.distributed_decode(stream, group_blocks=2, max_tokens=1024)
assert out == data, f"proc {proc_id}: distributed decode mismatch"

pathlib.Path(outfile).write_bytes(stream)
print(f"proc {proc_id}: OK {len(data)} -> {len(stream)} -> decode OK")
