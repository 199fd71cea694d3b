"""5p- vs 3p-chemistry fused scan+search throughput on one GPU.

Both chemistries run the same two-half edge-scan body with different
window geometry (ops/edgescan.py); this measures what the 5p branch costs
on the same batch geometry, median of N.

Run from the repo root: python tools/bench_5p.py
"""
from __future__ import annotations

import time

import numpy as np


def run(chem: str, samples: int = 3, B: int = 32768):
    from sicelore_tpu.models import readscan
    from sicelore_tpu.utils import dna, synth
    from sicelore_tpu.utils.config import PipelineConfig

    rng = np.random.default_rng(0)
    n_bc = 8192
    wl = synth.make_whitelist(rng, n_bc)
    mk = synth.make_read if chem == "3p" else synth.make_read_5p
    base = [mk(rng, wl[int(rng.integers(0, n_bc))],
               cdna_len=int(rng.integers(300, 700)), error_rate=0.04,
               reverse=bool(i % 2)) for i in range(B)]
    pats, _ = dna.encode_batch([w.encode() for w in wl], 16)
    model = readscan.ReadScanModel(PipelineConfig(chemistry=chem))
    model.prepare_search(pats, n_bc, radius=2)
    seqs = [r["seq"] for r in base]
    quals = [r["qual"] for r in base]
    out, res = model.finish_search(model.scan_search_async(seqs, quals))
    assert float(np.mean(out["stranded"])) > 0.9, chem
    assert float(np.mean(res["ed"] <= 2)) > 0.8, chem
    rates = []
    for s in range(samples):
        t0 = time.time()
        model.finish_search(model.scan_search_async(seqs, quals))
        rates.append(B / (time.time() - t0))
        print(f"  {chem} sample {s}: {rates[-1]:.0f} reads/s", flush=True)
    return float(np.median(rates))


def main():
    import bench
    print(bench.device_info(), bench.card_info())
    r3 = run("3p")
    r5 = run("5p")
    print(f"3p: {r3:.0f} reads/s")
    print(f"5p: {r5:.0f} reads/s ({r5 / r3:.2f}x of 3p)")


if __name__ == "__main__":
    main()
