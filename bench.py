"""Headline benchmarks on one GPU.

1. scanfastq device path (headline): fused edge scan (stranding + polyA/
   adapter/TSO geometry) + used-list barcode search — reference Step 1,
   baseline ~20.8k reads/s on a 96-core Promethion tower (BASELINE.md).
   Measured at BOTH an 8k and a 49k used-barcode list (the sweep is linear
   in list size; real PromethION runs carry tens of thousands).
2. consensus: batched banded-DP POA engine (spoa replacement) on a
   WTA-shaped molecule mix — baseline ~167 UMIs/s on 20 cores (SURVEY.md).
3. end-to-end: fastq dir in -> passed/ fastq out (pass 1 + chimera scan +
   pass 2 + read-name metadata + writes) on >= 100k reads, warm (one
   process) and cold (fresh processes against the persistent compile
   cache).

One process per card: the cold samples run as child processes BEFORE this
process touches JAX, so no two processes ever hold the card at once.
Throughputs are the MEDIAN of several samples. Fails unless JAX runs on a
GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"extra"}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BASELINE_READS_PER_S = 20_800.0  # 100M reads / 80 min, 96 cores
BASELINE_UMIS_PER_S = 167.0      # 600k UMIs/hour, 20 threads + spoa
ROOT = Path(__file__).resolve().parent


def card_info() -> str:
    """`name, power limit` of the card as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip()


def device_info() -> dict:
    """Platform, kind and count as JAX reports them; exits without a GPU."""
    import jax

    from sicelore_tpu.utils.jaxcache import enable_compile_cache
    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py needs an NVIDIA GPU; JAX found "
                 f"{devs[0].platform}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _make_reads(rng, wl, n, error_rate=0.05):
    """n reads: length-skewed cDNA (300-700 nt bulk, ~3% long 2-6 kb)
    plus ~2% random garbage."""
    from sicelore_tpu.utils import synth
    seqs, quals = [], []
    for i in range(n):
        u = i % 64
        if u == 37:
            L = int(rng.integers(60, 900))
            seqs.append(synth.random_seq(rng, L).encode())
            quals.append(bytes([33 + int(x) for x in rng.integers(2, 30, L)]))
            continue
        clen = int(rng.integers(2000, 6000) if u == 13
                   else rng.integers(300, 700))
        r = synth.make_read(rng, wl[int(rng.integers(0, len(wl)))],
                            cdna_len=clen, error_rate=error_rate,
                            reverse=bool(i % 2))
        seqs.append(r["seq"])
        quals.append(r["qual"])
    return seqs, quals


def bench_scan(n_bc=8192, samples=5, dispatches=2, verbose=False):
    """Pass-2 hot path: 2-bit mega-batch upload -> fused edge scan +
    used-list barcode search -> packed int16 download, depth-2 pipelined.
    Returns (median reads/s, per-sample reads/s)."""
    from collections import deque

    from sicelore_tpu.models import readscan
    from sicelore_tpu.utils import dna, synth

    rng = np.random.default_rng(0)
    B = 32768
    wl = synth.make_whitelist(rng, n_bc)
    seqs, quals = _make_reads(rng, wl, B)
    pats, _ = dna.encode_batch([w.encode() for w in wl], 16)

    model = readscan.ReadScanModel()
    model.prepare_search(pats, n_bc, radius=2)
    t0 = time.time()
    out, res = model.finish_search(model.scan_search_async(seqs, quals))
    if verbose:
        print(f"scan[{n_bc}] compile+first: {time.time() - t0:.1f}s",
              file=sys.stderr)
    assert float(np.mean(out["stranded"])) > 0.9
    assert float(np.mean(res["ed"] <= 2)) > 0.8

    per_sample = []
    for s in range(samples):
        q = deque()
        t0 = time.time()
        for _ in range(dispatches):
            q.append(model.scan_search_async(seqs, quals))
            if len(q) > 2:
                model.finish_search(q.popleft())
        while q:
            model.finish_search(q.popleft())
        per_sample.append(round(dispatches * B / (time.time() - t0), 1))
        if verbose:
            print(f"scan[{n_bc}] sample {s}: {per_sample[-1]} reads/s",
                  file=sys.stderr)
    return float(np.median(per_sample)), per_sample


def make_consensus_set(seed, M=2000):
    """WTA-shaped molecule mix (~50% molecules multi-read): 50% 1-read,
    20% 2-read, 30% 3..12-read molecules, 400-900 nt cDNA at 3% error."""
    from sicelore_tpu.utils import synth
    rng = np.random.default_rng(seed)
    molecules = []
    for _ in range(M):
        u = rng.random()
        n_reads = (1 if u < 0.5 else 2 if u < 0.7 else
                   int(rng.integers(3, 13)))
        true = synth.random_seq(rng, int(rng.integers(400, 900)))
        molecules.append([synth.mutate(rng, true, 0.03).encode()
                          for _ in range(n_reads)])
    return molecules


def bench_consensus(samples=5, M=2000, verbose=False):
    """Median UMIs/s over `samples` distinct molecule sets (two warm-up
    sets cover the padded-shape grid first). Returns (median, samples)."""
    from sicelore_tpu.ops.poa_tpu import BatchedConsensusEngine

    engine = BatchedConsensusEngine()
    t0 = time.time()
    engine(make_consensus_set(1, M))
    engine(make_consensus_set(2, M))
    if verbose:
        print(f"consensus compile+first: {time.time() - t0:.1f}s",
              file=sys.stderr)
    per_sample = []
    for s in range(samples):
        mols = make_consensus_set(100 + s, M)
        t0 = time.time()
        res = engine(mols)
        dt = time.time() - t0
        assert len(res) == M and all(r[0] for r in res)
        per_sample.append(round(M / dt, 1))
        if verbose:
            print(f"consensus sample {s}: {per_sample[-1]} UMIs/s",
                  file=sys.stderr)
    return float(np.median(per_sample)), per_sample


def write_e2e_dataset(out_dir: Path, n_reads=102_400, seed=2):
    """Synthetic fastq dir (4 files) + whitelist file for the e2e cell:
    384 cells plus 8,192 decoys; ~6% length-skewed long reads (2-8 kb
    cDNA), chimeric fusions and random garbage. Returns (fq_dir, wl_file,
    n_reads)."""
    from sicelore_tpu.utils import synth
    rng = np.random.default_rng(seed)
    n_cells = 384
    wl_cells = synth.make_whitelist(rng, n_cells)
    wl = wl_cells + synth.make_whitelist(np.random.default_rng(seed + 1),
                                         8192)
    seqs, quals = _make_reads(rng, wl_cells, n_reads, error_rate=0.04)
    for i in range(0, n_reads, 16):
        u = (i // 16) % 8
        if u == 0:      # length-skewed long read
            r = synth.make_read(rng, wl_cells[i % n_cells],
                                cdna_len=int(rng.integers(2000, 8000)),
                                error_rate=0.05, reverse=bool(i % 2))
        elif u == 1 and i % 48 == 16:   # chimera
            r = synth.make_chimera(rng, wl_cells[i % n_cells],
                                   wl_cells[(i + 7) % n_cells],
                                   cdna_len=500)
        elif u == 2 and i % 48 == 32:   # garbage
            s = synth.random_seq(rng, int(rng.integers(60, 900))).encode()
            r = {"seq": s, "qual": bytes([33 + int(x) for x in
                                          rng.integers(2, 30, len(s))])}
        else:
            continue
        seqs[i], quals[i] = r["seq"], r["qual"]
    fq = out_dir / "fq"
    fq.mkdir(parents=True)
    per_file = n_reads // 4
    for f in range(4):
        with open(fq / f"part{f}.fastq", "wb") as fh:
            for k in range(f * per_file, (f + 1) * per_file):
                fh.write(b"@read%d\n" % k + seqs[k] + b"\n+\n" + quals[k]
                         + b"\n")
    wl_file = out_dir / "wl.txt"
    wl_file.write_text("\n".join(wl))
    return fq, wl_file, 4 * per_file


def run_e2e_once(fq: Path, wl_file: Path, out: Path, model=None) -> dict:
    from sicelore_tpu.pipeline.scanfastq import ScanFastqPipeline
    t0 = time.time()
    stats = ScanFastqPipeline(whitelist=wl_file.read_text().split(),
                              chunk_size=32768, model=model).run([fq], out)
    return {"dt": time.time() - t0, "assigned": stats.bc_assigned,
            "total": stats.total_reads}


def bench_e2e_cold(fq, wl_file, work: Path, runs=3, verbose=False):
    """Fresh child processes, run one after another while this process
    stays off JAX; the first fills the persistent compile cache, the
    rest measure a cold start against it. Returns reads/s per run."""
    out = []
    for ci in range(runs):
        r = subprocess.run(
            [sys.executable, str(ROOT / "bench.py"), "--cold-run", str(fq),
             str(wl_file), str(work / f"out_cold{ci}")],
            capture_output=True, text=True, timeout=1800)
        d = json.loads(r.stdout.strip().splitlines()[-1])
        assert d["assigned"] > 0.8 * d["total"], d
        out.append(round(d["total"] / d["dt"], 1))
        if verbose:
            print(f"e2e cold {ci}: {out[-1]} reads/s", file=sys.stderr)
    return out


def bench_e2e_warm(fq, wl_file, work: Path, runs=3, verbose=False):
    from sicelore_tpu.models import readscan
    model = readscan.ReadScanModel()
    run_e2e_once(fq, wl_file, work / "out_warmup", model)
    per_run = []
    for i in range(runs):
        d = run_e2e_once(fq, wl_file, work / f"out{i}", model)
        assert d["assigned"] > 0.8 * d["total"], d
        per_run.append(round(d["total"] / d["dt"], 1))
        if verbose:
            print(f"e2e warm {i}: {per_run[-1]} reads/s", file=sys.stderr)
    return float(np.median(per_run)), per_run


def main(verbose: bool = False):
    import shutil
    import tempfile
    work = Path(tempfile.mkdtemp(prefix="bench_"))
    try:
        fq, wl_file, _ = write_e2e_dataset(work)
        cold = bench_e2e_cold(fq, wl_file, work, verbose=verbose)
        device = device_info()        # this process takes the card now
        card = card_info()
        scan_rps, scan_samples = bench_scan(n_bc=8192, verbose=verbose)
        scan49_rps, scan49_samples = bench_scan(n_bc=49152, samples=3,
                                                verbose=verbose)
        umis_ps, cons_samples = bench_consensus(verbose=verbose)
        e2e_rps, e2e_runs = bench_e2e_warm(fq, wl_file, work,
                                           verbose=verbose)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(card)
    print(json.dumps({
        "metric": "scanfastq_reads_per_s_per_chip",
        "value": round(scan_rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(scan_rps / BASELINE_READS_PER_S, 2),
        "device": dict(device, card=card),
        "extra": {
            "scan_samples": scan_samples,
            "scan_49k_bc_reads_per_s": round(scan49_rps, 1),
            "scan_49k_samples": scan49_samples,
            "consensus_umis_per_s": round(umis_ps, 1),
            "consensus_vs_baseline": round(umis_ps / BASELINE_UMIS_PER_S, 2),
            "consensus_samples": cons_samples,
            "e2e_scanfastq_reads_per_s": round(e2e_rps, 1),
            "e2e_vs_baseline": round(e2e_rps / BASELINE_READS_PER_S, 2),
            "e2e_samples": e2e_runs,
            "e2e_cold_samples": cold,
        },
    }))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--cold-run":
        device_info()
        print(json.dumps(run_e2e_once(Path(sys.argv[2]), Path(sys.argv[3]),
                                      Path(sys.argv[4]))))
    else:
        main(verbose="-v" in sys.argv)
