"""Benchmark harness.  Prints ONE JSON line with the headline metric.

Corpus: a deterministic 100 MB enwik8 stand-in (order-3 Markov text; the
reference binary compresses it to 31.1% at e0 vs 31.46% for enwik8 -- see
tools/make_corpus.py).  The reference C++ encoder/decoder is built from
/root/reference and timed on the same host and corpus, so `vs_baseline`
compares identical work on identical hardware.

Headline metric: level-0 encode throughput of the host pipeline (the
block-parallel native engine).  The full per-level table, decode numbers,
ratios, and the baseline measurements ride along in the same JSON object.
This harness times only the host path; the device path has no benchmark
yet (chip_smoke.py checks that it runs and prints smoke timings).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

SIZE = 100_000_000


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_call(fn, *args, repeats: int = 2):
    best = float("inf")
    out = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        best = min(best, time.perf_counter() - t0)
    return out, best


def bench_reference(data_path: pathlib.Path, level: int):
    ref = REPO / "build" / "oracle" / "zling_ref"
    if not ref.exists():
        try:
            subprocess.run(["sh", str(REPO / "tools" / "build_reference.sh")],
                           check=True, capture_output=True)
        except Exception:
            return None
    enc_out = "/tmp/zlt_bench_ref.z"
    dec_out = "/tmp/zlt_bench_ref.out"
    t_enc = t_dec = float("inf")
    for _ in range(2):  # best-of-2: this host's timing is noisy
        t0 = time.perf_counter()
        subprocess.run([str(ref), f"e{level}", str(data_path), enc_out],
                       check=True, capture_output=True)
        t_enc = min(t_enc, time.perf_counter() - t0)
        t0 = time.perf_counter()
        subprocess.run([str(ref), "d", enc_out, dec_out], check=True, capture_output=True)
        t_dec = min(t_dec, time.perf_counter() - t0)
    size = pathlib.Path(enc_out).stat().st_size
    return {"enc_mbps": SIZE / t_enc / 1e6, "dec_mbps": SIZE / t_dec / 1e6,
            "bytes": size}


def emit(results: dict) -> None:
    """Print the one-line headline JSON.  Called as soon as the host table
    exists and again after the optional counters run, so a kill during
    that run still leaves a recorded headline (the last complete line)."""
    e0 = results["levels"]["e0"]
    base = results["reference"].get("e0", {}).get("enc_mbps")
    vs = round(e0["enc_mbps"] / base, 3) if base else None
    print(json.dumps({
        "metric": "encode_throughput_e0_100MB_markov",
        "value": e0["enc_mbps"],
        "unit": "MB/s",
        "vs_baseline": vs,
        "detail": results,
    }), flush=True)


def main() -> None:
    from tools.make_corpus import cached_corpus

    log("generating/loading corpus...")
    data_path = cached_corpus(SIZE)
    data = data_path.read_bytes()

    from libzling_tpu import pipeline
    from libzling_tpu.native import engine

    results: dict = {"levels": {}, "reference": {}}
    for level in (0, 1, 2, 3, 4, 5, 6):
        ref = None
        if level <= 4:
            log(f"reference e{level}...")
            ref = bench_reference(data_path, level)
            if ref:
                results["reference"][f"e{level}"] = ref

        log(f"pipeline e{level}...")
        stream = pipeline.encode(data, level)  # warm-up (page faults, pools)
        _, t_enc = time_call(pipeline.encode, data, level)
        out = pipeline.decode(stream)
        assert out == data, "round-trip failed"
        _, t_dec = time_call(pipeline.decode, stream)
        if ref:
            assert len(stream) == ref["bytes"], (
                f"compressed size mismatch vs reference: {len(stream)} != {ref['bytes']}")
        if level == 5:
            # extended level: must beat the reference's best size
            ref4 = results["reference"].get("e4")
            if ref4:
                assert len(stream) < ref4["bytes"], "e5 must out-compress reference e4"
        if level == 6:
            # deepest extended level: must beat e5 or it has no reason to exist
            assert len(stream) < results["levels"]["e5"]["bytes"], \
                "e6 must out-compress e5"
        results["levels"][f"e{level}"] = {
            "enc_mbps": round(SIZE / t_enc / 1e6, 1),
            "dec_mbps": round(SIZE / t_dec / 1e6, 1),
            "bytes": len(stream),
            "ratio_pct": round(len(stream) / SIZE * 100, 3),
        }
        log(f"  e{level}: enc {results['levels'][f'e{level}']['enc_mbps']} MB/s "
            f"dec {results['levels'][f'e{level}']['dec_mbps']} MB/s "
            f"ratio {results['levels'][f'e{level}']['ratio_pct']}%"
            + (" (bit-exact)" if level <= 4 else " (extended level)"))

    # record the host table now, before the optional counters run
    emit(results)

    # counters A/B + observability: the default engine build compiles the
    # match-loop debug counters OUT (reference LIBZLING_DEBUG=0 analog;
    # measured ~7% on e0 encode).  A ZLT_COUNTERS=1 subprocess times the
    # counters-in build AND collects the counter values for the report.
    try:
        log("host e0 with counters compiled in (ZLT_COUNTERS=1)...")
        code = f"""
import json, sys, time
sys.path.insert(0, {str(REPO)!r})
from libzling_tpu import pipeline
data = open({str(data_path)!r}, 'rb').read()
pipeline.encode(data, 0)  # warm-up
best = float('inf')
for _ in range(2):
    t0 = time.perf_counter()
    pipeline.encode(data, 0)
    best = min(best, time.perf_counter() - t0)
print('withcnt:', len(data) / best / 1e6)
print('counters:', json.dumps(pipeline.counters()))
"""
        env = dict(os.environ, ZLT_COUNTERS="1")
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=600)
        # counters are namespaced by source: "native" comes from the
        # ZLT_COUNTERS=1 subprocess (match-loop counters compiled in),
        # "registry" from the main process's own runs — they are different
        # builds/processes and must not be merged into one flat dict
        results["counters"] = {}
        for line in r.stdout.splitlines():
            if line.startswith("withcnt:"):
                results["counters_on_enc_mbps_e0"] = round(
                    float(line.split()[1]), 1)
                log(f"  {results['counters_on_enc_mbps_e0']} MB/s")
            elif line.startswith("counters:"):
                results["counters"]["native"] = json.loads(
                    line.split(":", 1)[1])
    except Exception:
        pass

    # host metrics registry (level drops, schedule mispredicts) from the
    # main process's own runs
    try:
        results.setdefault("counters", {})["registry"] = (
            __import__("libzling_tpu.utils.metrics", fromlist=["registry"])
            .registry.snapshot()["counters"])
    except Exception:
        pass

    emit(results)


if __name__ == "__main__":
    main()
