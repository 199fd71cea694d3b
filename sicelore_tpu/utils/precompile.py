"""Warm the persistent XLA compile cache for every device shape a
scanfastq run touches.

The pipeline bounds shape diversity by dispatching in fixed
ReadScanModel.SLICE-read slices (models/readscan.py), so the full set of
shapes is small and enumerable: warm them once here, then every later
process (bench, production runs) finds its executables in the persistent
cache (utils/jaxcache.py) instead of compiling them.

Usage: `python -m sicelore_tpu precompile [--nbc N] [--full]`.
"""
from __future__ import annotations

import sys
import time


def warm(n_bc: int = 8192, full: bool = False, log=None) -> dict:
    """Compile+run each pipeline kernel on dummy data at production shapes.

    n_bc: used-barcode list size to warm the sweep for (rounded up to the
    barcode tile inside prepare_search). full=False warms only the two hot
    shapes (SLICE and the 256 tail bucket); full=True walks every
    power-of-two tail bucket and the internal-scan length buckets too.
    """
    import numpy as np

    from sicelore_tpu.models import readscan
    from sicelore_tpu.ops import editdist
    from sicelore_tpu.utils import dna
    from sicelore_tpu.utils.config import PipelineConfig

    if log is None:
        def log(*a):
            print(*a, file=sys.stderr, flush=True)

    from sicelore_tpu.utils.jaxcache import enable_compile_cache
    enable_compile_cache()
    cfg = PipelineConfig()
    model = readscan.ReadScanModel(cfg)
    rng = np.random.default_rng(0)
    wl = sorted({"".join(rng.choice(list("ACGT"), 16)) for _ in range(n_bc)})
    pats, _ = dna.encode_batch([w.encode() for w in wl], 16)
    model.prepare_search(pats, len(wl), radius=2)

    S = readscan.ReadScanModel.SLICE
    # mega dispatch shapes are [C, SLICE, .]; tail batches pad into C=1
    cs = [1, model.MAX_C]
    if full:
        c = 2
        while c < model.MAX_C:
            cs.append(c)
            c *= 2

    jobs = []
    bases = np.frombuffer(b"ACGT", np.uint8)
    for C in sorted(cs):
        B = C * S
        seqs = [bytes(rng.choice(bases, 600)) for _ in range(B)]
        quals = [b"I" * 600 for _ in range(B)]
        jobs.append((f"scan_search_C{C}", lambda s=seqs, q=quals:
                     model.finish_search(model.scan_search_async(s, q))))
        jobs.append((f"pass1_C{C}", lambda s=seqs, q=quals:
                     model.scan_pass1(s, q)))
    # int8 fallback path (N-containing reads): one tiny batch
    dirty_seqs = [b"ACGTN" * 120 for _ in range(8)]
    dirty_quals = [b"I" * 600 for _ in range(8)]
    jobs.append(("fallback_int8", lambda:
                 model.finish_search(
                     model.scan_search_async(dirty_seqs, dirty_quals))))

    # tiled chimera scan: tile-count buckets (reads > 2*E+k produce tiles)
    def warm_tiles(n_long):
        long_seqs = [bytes(rng.choice(bases, 3000)) for _ in range(n_long)]
        model.finish_internal_tiles(model.internal_tiles_async(long_seqs))
    tile_counts = [64, 512] + ([1024, 2048] if full else [])
    for n in tile_counts:
        jobs.append((f"tiles_{n}", lambda n=n: warm_tiles(n)))

    # consensus engine: Lc buckets + assemble shapes
    def warm_consensus(lc, n_mol):
        from sicelore_tpu.ops.poa_tpu import BatchedConsensusEngine
        eng = BatchedConsensusEngine()
        mols = []
        for i in range(n_mol):
            t = bytes(rng.choice(bases, lc - 8))
            mols.append([t, t, t])
        eng(mols)
    for lc, nm in [(256, 8), (512, 8)] + ([(1024, 8), (2048, 8)]
                                          if full else []):
        jobs.append((f"consensus_L{lc}", lambda lc=lc, nm=nm:
                     warm_consensus(lc, nm)))
    if full:
        # internal scan: length buckets (chimera path, long reads only)
        for L in (1024, 2048, 4096):
            codes = np.full((8, L), dna.PAD, np.int8)
            lens = np.full(8, L, np.int32)
            jobs.append((f"internal_L{L}", lambda c=codes, l=lens:
                         model.scan_internal(c, l)))

    # XLA compiles concurrently from several threads
    from concurrent.futures import ThreadPoolExecutor
    times = {}

    def run(item):
        name, fn = item
        t0 = time.time()
        fn()
        times[name] = round(time.time() - t0, 1)
        log(f"{name}: {times[name]}s")

    with ThreadPoolExecutor(max_workers=4) as ex:
        list(ex.map(run, jobs))
    return times
