"""Kernel-vs-plain and dispatch-shape timings on one GPU, end to end.

For each hand-written Triton kernel, the same user-level call runs twice
in this process: once as shipped (the kernel) and once with the kernel
swapped for its plain jnp version, so the comparison includes everything
around the kernel. Also times the fused scan's slice dispatch: one flat
call over the whole batch against the 2,048-read lax.map slices.

Run from the repo root: python tools/gpu_timings.py
Prints one line per measurement and the card's name and power limit.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def median_time(fn, reps=3):
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def scan_e2e(n_bc, seqs, quals, wl):
    """Warm fused scan+search over 32k reads (host encode, upload, scan,
    sweep, download, host finalize), median seconds."""
    from sicelore_tpu.models import readscan
    from sicelore_tpu.utils import dna
    pats, _ = dna.encode_batch([w.encode() for w in wl[:n_bc]], 16)
    model = readscan.ReadScanModel()
    model.prepare_search(pats, n_bc, radius=2)
    res = model.finish_search(model.scan_search_async(seqs, quals))
    t = median_time(lambda: model.finish_search(
        model.scan_search_async(seqs, quals)))
    return t, res


def main():
    import jax
    import jax.numpy as jnp

    import bench
    import chip_smoke
    from sicelore_tpu.models import readscan
    from sicelore_tpu.ops import bcsearch
    from sicelore_tpu.ops import poa_tpu as pt
    from sicelore_tpu.utils import dna, synth

    dev = bench.device_info()
    card = bench.card_info()
    print(f"device {dev}, card {card}", flush=True)
    rng = np.random.default_rng(0)
    wl = synth.make_whitelist(rng, 49152)
    seqs, quals = bench._make_reads(rng, wl[:8192], 32768)

    # --- barcode sweep: kernel vs plain inside the fused scan. The jit
    # caches are cleared around each swap: a cached trace of a jitted
    # caller would otherwise keep the kernel it was traced with ---
    kernel_fn = bcsearch.sweep_top2_triton
    for n_bc in (8192, 49152):
        t_k, r_k = scan_e2e(n_bc, seqs, quals, wl)
        bcsearch.sweep_top2_triton = (
            lambda w, p, n, m, track_pos=False, **_:
            bcsearch.sweep_top2_ref(w, p, n, m, track_pos=track_pos))
        jax.clear_caches()
        try:
            t_p, r_p = scan_e2e(n_bc, seqs, quals, wl)
        finally:
            bcsearch.sweep_top2_triton = kernel_fn
            jax.clear_caches()
        same = all(np.array_equal(r_k[1][k], r_p[1][k]) for k in r_k[1])
        print(f"fused scan 32768 reads, {n_bc} barcodes: kernel "
              f"{32768 / t_k:.0f} reads/s ({t_k * 1e3:.1f} ms), plain "
              f"{32768 / t_p:.0f} reads/s ({t_p * 1e3:.1f} ms); equal "
              f"{same}", flush=True)

    # --- band alignment: kernel vs plain inside the consensus engine ---
    mols = chip_smoke.consensus_molecules(0)
    kernel_fn = pt.band_records_triton
    out = {}
    for name in ("kernel", "plain"):
        if name == "plain":
            pt.band_records_triton = (
                lambda c, r, cl, rl, W, **_: pt.band_records_ref(
                    c, r, cl, rl, W=W))
            jax.clear_caches()
        try:
            eng = pt.BatchedConsensusEngine()
            out[name] = (median_time(lambda: eng(mols)), eng(mols))
        finally:
            pt.band_records_triton = kernel_fn
            jax.clear_caches()
    print(f"consensus {len(mols)} molecules: kernel "
          f"{len(mols) / out['kernel'][0]:.0f} UMIs/s "
          f"({out['kernel'][0]:.3f} s), plain "
          f"{len(mols) / out['plain'][0]:.0f} UMIs/s "
          f"({out['plain'][0]:.3f} s); equal "
          f"{out['kernel'][1] == out['plain'][1]}", flush=True)

    # --- band alignment: kernel vs plain inside the native aligner ---
    from sicelore_tpu.align import NativeAligner
    genome = synth.random_seq(rng, 60_000)
    exons = [(10_000, 11_200), (30_000, 30_500), (31_300, 31_900)]
    reads = []
    for i in range(2000):
        cdna = (genome[exons[0][0]:exons[0][1]] if i % 2 == 0 else
                genome[exons[1][0]:exons[1][1]]
                + genome[exons[2][0]:exons[2][1]])
        reads.append(synth.mutate_fast(rng, cdna.encode(), 0.04))
    names = [b"r%d" % i for i in range(len(reads))]
    aligner = NativeAligner({"chrS": genome.encode()})
    res = {}
    for name in ("kernel", "plain"):
        if name == "plain":
            pt.band_records_triton = (
                lambda c, r, cl, rl, W, **_: pt.band_records_ref(
                    c, r, cl, rl, W=W))
            jax.clear_caches()
        try:
            t = median_time(lambda: aligner.align_batch(names, reads), 2)
            res[name] = (t, [(r.pos, r.cigar) for r in
                             aligner.align_batch(names, reads)])
        finally:
            pt.band_records_triton = kernel_fn
            jax.clear_caches()
    print(f"native aligner {len(reads)} reads (4% error, 60 kb genome): "
          f"kernel {len(reads) / res['kernel'][0]:.0f} reads/s, plain "
          f"{len(reads) / res['plain'][0]:.0f} reads/s; equal "
          f"{res['kernel'][1] == res['plain'][1]}", flush=True)

    # --- fused-scan dispatch: one flat call (make_mega2) vs the
    # 2,048-read lax.map slices it replaced ---
    from sicelore_tpu.ops import edgescan as eg
    pats, _ = dna.encode_batch([w.encode() for w in wl[:8192]], 16)
    model = readscan.ReadScanModel()
    model.prepare_search(pats, 8192, radius=2)
    inner = readscan.make_scan_search2_body(model.cfg, "sweep")
    packed, *_ = eg.encode_composite_tm(seqs, quals)
    arr3, spans = model._stack3(packed, len(seqs))
    assert spans == [(0, arr3.shape[0])], spans
    stack = jnp.asarray(arr3)
    extra = (model.peq_ad, model.peq_adc, model.peq_tso, model._peq_bc,
             model._nvalid, model._qgram_t)
    flat = readscan.make_mega2(inner)

    @jax.jit
    def mapped(stack3, *args):
        C, R, S = stack3.shape
        res = jax.lax.map(lambda p: inner(p, *args), stack3)
        return jnp.transpose(res, (1, 0, 2)).reshape(res.shape[1], C * S)

    res = {}
    for name, fn in (("lax.map", mapped), ("flat", flat)):
        t0 = time.perf_counter()
        first = jax.block_until_ready(fn(stack, *extra))
        t_first = time.perf_counter() - t0
        t = median_time(lambda: jax.block_until_ready(fn(stack, *extra)))
        res[name] = np.asarray(first)
        print(f"fused scan dispatch {name}: {t * 1e3:.2f} ms device+"
              f"dispatch for 32768 reads (first call incl. compile "
              f"{t_first:.1f} s)", flush=True)
    print(f"flat == lax.map: {np.array_equal(res['flat'], res['lax.map'])}")
    print(card)


if __name__ == "__main__":
    main()
