"""Stage-level profile of the warm scanfastq e2e: wraps the pipeline's own
stage boundaries with wall clocks (a cProfile run adds 3-10x interpreter
overhead), on a 32k-read default.

Usage: python profile_e2e.py [n_reads] [--cprofile]
"""
import sys
import time

import numpy as np

import bench


def main(n_reads=32_768, use_cprofile=False):
    bench.device_info()
    import shutil
    import tempfile
    from pathlib import Path

    from sicelore_tpu.models import readscan
    from sicelore_tpu.pipeline import scanfastq as sf
    from sicelore_tpu.pipeline.scanfastq import ScanFastqPipeline
    from sicelore_tpu.utils import synth

    acc = {}

    def wrap(obj, name, key):
        orig = getattr(obj, name)

        def f(*a, **k):
            t0 = time.time()
            r = orig(*a, **k)
            acc[key] = acc.get(key, 0.0) + time.time() - t0
            return r

        setattr(obj, name, f)

    wrap(sf.ScanFastqPipeline, "pass2_emit", "emit (native records+stats)")
    wrap(sf.ScanFastqPipeline, "_emit_records", "emit: native+marshal only")
    wrap(readscan, "build_tiles", "tiles: build (native)")
    wrap(readscan.ReadScanModel, "scan_pass1_async", "pass1 dispatch")
    wrap(readscan.ReadScanModel, "finish_pass1", "pass1 finish (d2h+host)")
    wrap(readscan.ReadScanModel, "scan_search_async",
         "pass2 dispatch (encode+h2d)")
    wrap(readscan.ReadScanModel, "finish_search", "pass2 finish (d2h+host)")
    wrap(readscan.ReadScanModel, "internal_tiles_async", "tiles dispatch")
    wrap(readscan.ReadScanModel, "finish_internal_tiles", "tiles finish")
    wrap(readscan.ReadScanModel, "scan_pass1_full_async", "pass1F dispatch")
    wrap(readscan.ReadScanModel, "finish_pass1_full", "pass1F finish")
    wrap(readscan.ReadScanModel, "bc_sweep_async", "sweep dispatch")
    wrap(readscan.ReadScanModel, "finish_bc_sweep", "sweep finish")

    rng = np.random.default_rng(2)
    wl_cells = synth.make_whitelist(rng, 384)
    wl = wl_cells + synth.make_whitelist(np.random.default_rng(3), 8192)
    seqs, quals = bench._make_reads(rng, wl_cells, n_reads, error_rate=0.04)
    tmp = Path(tempfile.mkdtemp(prefix="prof_e2e_"))
    try:
        fq = tmp / "fq"
        fq.mkdir()
        with open(fq / "a.fastq", "wb") as fh:
            for k in range(n_reads):
                fh.write(b"@r%d\n" % k + seqs[k] + b"\n+\n" + quals[k]
                         + b"\n")
        model = readscan.ReadScanModel()
        import os as _os
        _cp = _os.environ.get("PROF_CACHE")
        _cp = None if _cp is None else _cp == "1"
        ScanFastqPipeline(whitelist=wl, chunk_size=32768,
                          model=model, cache_pass1=_cp).run([fq], tmp / "o0")
        acc.clear()
        pr = None
        if use_cprofile:
            import cProfile
            pr = cProfile.Profile()
            pr.enable()
        t0 = time.time()
        ScanFastqPipeline(whitelist=wl, chunk_size=32768,
                          model=model, cache_pass1=_cp).run([fq], tmp / "o1")
        wall = time.time() - t0
        if pr is not None:
            pr.disable()
        print(f"\nwarm e2e: {wall:.2f}s = {n_reads / wall:.0f} reads/s "
              f"({n_reads / wall / bench.BASELINE_READS_PER_S:.2f}x) | "
              f"{bench.card_info()}")
        other = wall - sum(acc.values())
        for k, v in sorted(acc.items(), key=lambda kv: -kv[1]):
            print(f"  {k:34s} {v:6.2f}s  {100 * v / wall:5.1f}%")
        print(f"  {'fastq IO + loop glue':34s} {other:6.2f}s  "
              f"{100 * other / wall:5.1f}%")
        if pr is not None:
            import pstats
            pstats.Stats(pr).sort_stats("cumulative").print_stats(25)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
        else 32_768
    main(n, "--cprofile" in sys.argv)
