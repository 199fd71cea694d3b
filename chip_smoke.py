"""Smoke test of the main path on one NVIDIA GPU.

One process drives the system through the entry points a user calls,
with every dataset generated from --seed:

  device     platform, card, compile-cache dir; native/ rebuilt from the
             committed sources into a fresh build dir (a library that
             fails to load fails the smoke)
  gpu-tests  the card-only pytest tests (marker `gpu`)
  kernels    each Triton kernel as compiled for the card vs its plain
             version at real widths, exact equality, both timed; the
             plain edge scan on the card vs the CPU backend
  scanfastq  `scanfastq` through sicelore_tpu.__main__.main on 131,072
             reads in 4 fastq files, 2,048 cells, a 737,280-entry
             whitelist; assignment checked against the known truth
  run        `run --nativeAlign --consensus` on 4,096 reads; the gap
             extensions take the Triton band alignment and never the
             Pallas interpreter; gene/isoform matrices checked
  consensus  the engine on the benchmark's WTA mix plus 256 long
             molecules, byte-equal to the plain oracle

Every phase prints its wall and compile seconds and the implementation
it ran; a failing phase raises, so the script exits non-zero. The last
line is the JSON result.

  python chip_smoke.py                # one card
  python chip_smoke.py --four-cards   # only the data-parallel path on a
                                      # 4-card mesh, vs one card

Without a GPU it exits non-zero and prints no result line.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke_work"          # generated datasets (git-ignored)
NATIVE_BUILD = ROOT / "native" / "build-smoke"

# sizes (the bench's widths; counts cut only where the run time needs it)
SWEEP_READS, SWEEP_BARCODES = 32768, (8192, 49152)
EDGE_READS = 32768
BAND_PAIRS, BAND_BUCKETS = 2048, (256, 512, 1024, 2048)
SCAN_READS, SCAN_CELLS, SCAN_WHITELIST = 131_072, 2048, 737_280
RUN_READS = 4096
CONS_MOLECULES, CONS_LONG = 2000, 256
FOUR_SCAN_READS, FOUR_BARCODES = 32768, 8192

_compile_s = [0.0]


def log(*a):
    print(*a, flush=True)


def _on_duration(event: str, duration: float, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _compile_s[0] += duration


@contextlib.contextmanager
def phase(name: str):
    log(f"== phase {name}")
    c0, t0 = _compile_s[0], time.time()
    yield
    log(f"phase {name}: wall {time.time() - t0:.2f} s, "
        f"compile {_compile_s[0] - c0:.2f} s")


def timed(fn, *args, reps: int = 3):
    """(result, median seconds) of fn(*args) after one warm-up call."""
    import jax
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def impl_of(fn, *args) -> str:
    """Which implementation the compiled program holds: a Triton kernel
    or XLA's own code."""
    import jax
    txt = jax.jit(fn).lower(*args).as_text()
    return "pallas-triton" if "triton" in txt else "xla"


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip()


def require_gpu(n: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        sys.stderr.write(f"chip_smoke.py: no GPU found (JAX platform "
                         f"{devs[0].platform}, {len(devs)} device(s); "
                         f"{n} GPU(s) needed)\n")
        sys.exit(2)
    return devs


# ---------------------------------------------------------------------------
# phases (one card)
# ---------------------------------------------------------------------------

def phase_device():
    import jax

    from sicelore_tpu.utils.jaxcache import cache_dir
    d = jax.devices()[0]
    log(f"platform {d.platform}, device_kind {d.device_kind}, "
        f"devices {len(jax.devices())}")
    log(f"card {card_line()}")
    log(f"compile cache {cache_dir()}")
    shutil.rmtree(NATIVE_BUILD, ignore_errors=True)
    r = subprocess.run(["make", "-C", str(ROOT / "native"),
                        f"BUILD={NATIVE_BUILD}"], capture_output=True,
                       text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"native build failed:\n{r.stdout}\n{r.stderr}")
    from sicelore_tpu.io import native
    assert native.BUILD_DIR == NATIVE_BUILD, native.BUILD_DIR
    lib, ext = native.get_lib(), native.get_hostenc()
    if lib is None or ext is None:
        raise RuntimeError(f"native library failed to load from "
                           f"{NATIVE_BUILD}: bgzf={lib} hostenc={ext}")
    log(f"native libraries loaded: {lib._name}, {ext.__file__}")


def phase_gpu_tests():
    import pytest
    os.environ["SICELORE_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      str(ROOT / "tests" / "test_gpu_kernels.py")])
    if rc != 0:
        raise RuntimeError(f"card-only tests failed (pytest exit {rc})")


def phase_kernels(seed: int):
    import jax
    import jax.numpy as jnp

    import bench
    from sicelore_tpu.models.readscan import ReadScanModel
    from sicelore_tpu.ops import bcsearch, editdist
    from sicelore_tpu.ops import edgescan as eg
    from sicelore_tpu.ops import poa_tpu as pt
    from sicelore_tpu.utils import synth

    rng = np.random.default_rng(seed)
    model = ReadScanModel()
    W, m, B = model.bc_window_width, 16, SWEEP_READS
    pad = model.cfg.readscanner.test_plus_minus_pos
    for N in SWEEP_BARCODES:
        pats = rng.integers(0, 4, (N, m)).astype(np.int8)
        wins = rng.integers(0, 4, (B, W)).astype(np.int8)
        pick = rng.integers(0, N, B)
        planted = rng.random(B) < 0.9
        wins[planted, pad:pad + m] = pats[pick[planted]]
        sub = rng.integers(0, m, B)
        wins[np.arange(B), pad + sub] = (wins[np.arange(B), pad + sub]
                                         + (rng.random(B) < 0.5)) % 4
        args = (jnp.asarray(wins.T.astype(np.int32)),
                jnp.asarray(editdist.build_peq(pats)),
                jnp.asarray([N], jnp.int32))
        ker, t_ker = timed(functools.partial(bcsearch.sweep_top2_triton,
                                             m=m), *args)
        ref, t_ref = timed(functools.partial(bcsearch.sweep_top2_ref,
                                             m=m), *args)
        assert np.array_equal(np.asarray(ker), np.asarray(ref)), \
            f"barcode sweep kernel != plain at N={N}"
        impl = impl_of(functools.partial(bcsearch.sweep_top2, m=m), *args)
        log(f"barcode sweep B={B} N={N} W={W}: exact; kernel "
            f"{t_ker * 1e3:.2f} ms, plain {t_ref * 1e3:.2f} ms; "
            f"sweep_top2 -> {impl}")

    B = EDGE_READS
    seqs, quals = bench._make_reads(rng, synth.make_whitelist(rng, 64), B)
    packed, *_ = eg.encode_composite_tm(seqs, quals)
    fn = jax.jit(eg.make_edge_scan2_packed(model.cfg))
    args = (jnp.asarray(packed), model.peq_ad, model.peq_adc, model.peq_tso)
    gpu, t_edge = timed(fn, *args)
    cpu = fn(*jax.device_put(args, jax.devices("cpu")[0]))
    assert np.array_equal(np.asarray(gpu), np.asarray(cpu)), \
        "edge scan on the card != on the CPU backend"
    log(f"edge scan B={B}: card == CPU backend, exact; card "
        f"{t_edge * 1e3:.2f} ms; impl {impl_of(fn, *args)}")

    for Lc in BAND_BUCKETS:
        P = BAND_PAIRS
        Wb = pt.w_for(Lc)
        PADL = pt.padl_for(Wb)
        Lrp = ((PADL + Lc + Wb + 127) // 128) * 128
        cent = np.zeros((Lc, P), np.int8)
        reads = np.full((Lrp, P), 3, np.int8)
        cl = rng.integers(Lc // 2 + 1, Lc + 1, P).astype(np.int32)
        rl = np.zeros(P, np.int32)
        for p in range(P):
            t = synth.random_bytes(rng, int(cl[p]))
            r = synth.mutate_fast(rng, t, 0.05)[:int(cl[p]) + Wb // 2 - 5]
            cent[:cl[p], p] = np.frombuffer(t.translate(_CODE), np.int8)
            reads[PADL:PADL + len(r), p] = np.frombuffer(
                r.translate(_CODE), np.int8)
            rl[p] = len(r)
        i_row = np.arange(Lrp)[:, None] - Wb // 2
        rv = np.where((i_row >= 1) & (i_row <= rl[None, :]), reads, 4)
        args = (jnp.asarray(cent), jnp.asarray(rv.astype(np.int8)),
                jnp.asarray(cl), jnp.asarray(rl))
        ker, t_ker = timed(functools.partial(pt.band_records_triton, W=Wb),
                           *args)
        ref, t_ref = timed(functools.partial(pt.band_records_ref, W=Wb),
                           *args)
        for a, b in zip(ker, ref):
            assert np.array_equal(np.asarray(a), np.asarray(b)), \
                f"band alignment kernel != plain at Lc={Lc}"
        feas = float(np.asarray(ref[1]).mean())
        impl = impl_of(functools.partial(pt.band_records, W=Wb), *args)
        log(f"band alignment Lc={Lc} W={Wb} pairs={P}: exact "
            f"(feasible {feas:.3f}); kernel {t_ker * 1e3:.2f} ms, plain "
            f"{t_ref * 1e3:.2f} ms; band_records -> {impl}")


_CODE = bytes.maketrans(b"ACGT", bytes([0, 1, 2, 3]))


def _scan_dataset(seed: int, n_reads: int, n_cells: int, wl_size: int):
    """4 fastq files + whitelist; read names carry the truth cell."""
    from sicelore_tpu.utils import synth
    rng = np.random.default_rng(seed)
    cells = synth.make_whitelist(rng, n_cells)
    cell_set = set(cells)
    codes = rng.integers(0, 4, (wl_size * 2, 16)).astype(np.uint8)
    decoys = np.unique(np.frombuffer(b"ACGT", np.uint8)[codes].view("S16"))
    decoys = [d.decode() for d in decoys if d.decode() not in cell_set]
    wl = cells + decoys[:wl_size - n_cells]
    assert len(wl) == wl_size
    d = WORK / "scan"
    shutil.rmtree(d, ignore_errors=True)
    (d / "fq").mkdir(parents=True)
    (d / "wl.txt").write_text("\n".join(wl) + "\n")
    truth = {}
    per_file = n_reads // 4
    n_chim = 0
    for f in range(4):
        with open(d / "fq" / f"part{f}.fastq", "wb") as fh:
            for k in range(f * per_file, (f + 1) * per_file):
                u = k % 64
                ci = int(rng.integers(0, n_cells))
                name = f"r{k}"
                if u == 37:                                  # garbage
                    L = int(rng.integers(60, 900))
                    seq = synth.random_bytes(rng, L)
                    qual = bytes(33 + rng.integers(2, 30, L).astype(np.uint8))
                elif u == 21:                                # chimera
                    c2 = int(rng.integers(0, n_cells))
                    r1 = synth.make_read_fast(rng, cells[ci], 500, 0.04)
                    r2 = synth.make_read_fast(rng, cells[c2], 500, 0.04)
                    seq, qual = r1["seq"] + r2["seq"], r1["qual"] + r2["qual"]
                    truth[name], truth[name + "sp2"] = cells[ci], cells[c2]
                    n_chim += 1
                else:
                    clen = int(rng.integers(2000, 8000) if u in (5, 13, 45,
                                                                 61)
                               else rng.integers(300, 700))
                    r = synth.make_read_fast(rng, cells[ci], clen, 0.04,
                                             reverse=bool(k % 2))
                    seq, qual = r["seq"], r["qual"]
                    truth[name] = cells[ci]
                fh.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n"
                         + qual + b"\n")
    return d, truth, n_chim


def phase_scanfastq(seed: int):
    from sicelore_tpu.__main__ import main
    from sicelore_tpu.io import fastq
    from sicelore_tpu.pipeline import readname

    n_reads, n_cells, wl_size = SCAN_READS, SCAN_CELLS, SCAN_WHITELIST
    t0 = time.time()
    d, truth, n_chim = _scan_dataset(seed, n_reads, n_cells, wl_size)
    log(f"dataset: {n_reads} reads in 4 files, {n_cells} cells, whitelist "
        f"{wl_size}, {n_chim} chimeras ({time.time() - t0:.1f} s)")
    out = d / "out"
    t0 = time.time()
    rc = main(["scanfastq", "-d", str(d / "fq"), "-o", str(out),
               "--whitelist", str(d / "wl.txt"), "-b", "2"])
    dt = time.time() - t0
    assert rc in (0, None), rc
    stats = json.loads((out / "scanner_stats.json").read_text())
    n_ok = n_tot = 0
    for f in sorted((out / "passed").iterdir()):
        for chunk in fastq.read_fastq(f):
            for nm in chunk.names:
                info = readname.parse_name(nm)
                assert info is not None, nm
                if info.orig_name in truth:
                    n_tot += 1
                    n_ok += info.bc == truth[info.orig_name]
    rate = n_ok / max(n_tot, 1)
    log(f"scanfastq: {dt:.1f} s ({n_reads / dt:.0f} reads/s incl. "
        f"compile), total {stats.get('total_reads')}, assigned "
        f"{stats.get('bc_assigned')}, chimera splits "
        f"{stats.get('split_chimeric')}, passed-with-truth {n_tot}, "
        f"truth rate {rate:.5f}")
    assert stats.get("total_reads") == n_reads, stats
    assert n_tot > 0.8 * n_reads, (n_tot, n_reads)
    assert rate > 0.99, rate
    assert stats.get("split_chimeric", 0) >= 1, stats


def phase_run(seed: int):
    from jax.experimental import pallas as pl

    from sicelore_tpu.__main__ import main
    from sicelore_tpu.align import extend
    from sicelore_tpu.utils import dna, synth

    # no Pallas interpreter on this path: an interpret-mode call fails
    real_call = pl.pallas_call

    def guarded(*a, **kw):
        if kw.get("interpret"):
            raise RuntimeError("Pallas interpreter reached")
        return real_call(*a, **kw)

    pl.pallas_call = guarded
    sigs: dict = {}
    real_gap_fn = extend._gap_fn

    def recording_gap_fn(Lc):
        fn = real_gap_fn(Lc)

        def call(*args):
            sigs[Lc] = args
            return fn(*args)
        return call

    extend._gap_fn = recording_gap_fn
    n_reads = RUN_READS
    try:
        rng = np.random.default_rng(seed + 1)
        d = WORK / "run"
        shutil.rmtree(d, ignore_errors=True)
        (d / "fq").mkdir(parents=True)
        genome = synth.random_seq(rng, 60_000)
        gene1 = (10_000, 11_200)
        g2e1, g2e2 = (30_000, 30_500), (31_300, 31_900)
        wl = synth.make_whitelist(rng, 12)
        with open(d / "ref.fa", "w") as fh:
            fh.write(">chrS\n")
            for i in range(0, len(genome), 80):
                fh.write(genome[i:i + 80] + "\n")
        with open(d / "ref.refflat", "w") as fh:
            fh.write(f"G1\tT1\tchrS\t+\t{gene1[0]}\t{gene1[1]}\t{gene1[0]}\t"
                     f"{gene1[1]}\t1\t{gene1[0]},\t{gene1[1]},\n")
            fh.write(f"G2\tT2\tchrS\t+\t{g2e1[0]}\t{g2e2[1]}\t{g2e1[0]}\t"
                     f"{g2e2[1]}\t2\t{g2e1[0]},{g2e2[0]},\t"
                     f"{g2e1[1]},{g2e2[1]},\n")
        (d / "wl.txt").write_text("\n".join(wl))
        with open(d / "fq" / "reads.fastq", "wb") as fh:
            for i in range(n_reads):
                cdna = (genome[gene1[0]:gene1[1]] if i % 2 == 0 else
                        genome[g2e1[0]:g2e1[1]] + genome[g2e2[0]:g2e2[1]])
                umi = synth.random_seq(rng, 12)
                stranded = (synth.TSO + cdna + "A" * 20
                            + dna.revcomp_str(umi)
                            + dna.revcomp_str(wl[i % 12])
                            + dna.revcomp_str(synth.ADAPTER)).encode()
                stranded = synth.mutate_fast(rng, stranded, 0.04)
                seq = (synth.revcomp_bytes(stranded) if i % 3 == 0
                       else stranded)
                fh.write(b"@rd%d\n" % i + seq + b"\n+\n" + b"I" * len(seq)
                         + b"\n")
        out = d / "out"
        t0 = time.time()
        rc = main(["run", "-d", str(d / "fq"), "-r", str(d / "ref.fa"),
                   "-a", str(d / "ref.refflat"), "-o", str(out),
                   "--whitelist", str(d / "wl.txt"), "-b", "2",
                   "--nativeAlign", "--consensus", "--no-resume"])
        assert rc in (0, None), rc
        log(f"run --nativeAlign --consensus: {n_reads} reads in "
            f"{time.time() - t0:.1f} s")
    finally:
        pl.pallas_call = real_call
        extend._gap_fn = real_gap_fn
    assert sigs, "no gap extension reached the band alignment"
    for Lc, args in sorted(sigs.items()):
        impl = impl_of(real_gap_fn(Lc), *args)
        log(f"gap extension bucket Lc={Lc}: {args[0].shape[1]} pairs -> "
            f"{impl}")
        assert impl == "pallas-triton", impl
    rows = (out / "isomatrix" / "sicelore_genematrix.txt"
            ).read_text().splitlines()
    hdr = rows[0].split("\t")[1:]
    mat = {r.split("\t")[0]: list(map(int, r.split("\t")[1:]))
           for r in rows[1:]}
    log("gene matrix:\n" + "\n".join(rows))
    assert set(mat) == {"G1", "G2"}, set(mat)
    even = {wl[i] for i in range(0, 12, 2)}
    for g, want in (("G1", even), ("G2", set(wl) - even)):
        got = {bc for bc, c in zip(hdr, mat[g]) if c > 0}
        assert got == want, (g, got)
    iso = (out / "isomatrix" / "sicelore_isomatrix.txt").read_text()
    log("isoform matrix:\n" + iso.strip())
    assert "\tT1\t1\t" in iso and "\tT2\t2\t" in iso
    cons = (out / "consensus.fastq").read_bytes().count(b"\n+\n")
    log(f"run consensus records: {cons} (the aligned BAM carries no read "
        f"sequence tags, so the consensus stage has no cDNA to use)")


def consensus_molecules(seed: int):
    """The benchmark's WTA mix (2,000 molecules, 400-900 nt, 3% error)
    plus 256 molecules with 1.5-2 kb centers for the 2048 bucket."""
    import bench
    from sicelore_tpu.utils import synth
    mols = bench.make_consensus_set(seed, CONS_MOLECULES)
    rng = np.random.default_rng(seed + 7)
    for _ in range(CONS_LONG):
        t = synth.random_bytes(rng, int(rng.integers(1500, 2000)))
        mols.append([synth.mutate_fast(rng, t, 0.03)
                     for _ in range(int(rng.integers(3, 9)))])
    return mols


def phase_consensus(seed: int):
    from sicelore_tpu.ops import poa_tpu as pt

    mols = consensus_molecules(seed)
    eng = pt.BatchedConsensusEngine()
    t0 = time.time()
    got = eng(mols)
    t_first = time.time() - t0
    t0 = time.time()
    got2 = eng(mols)
    t_warm = time.time() - t0
    t0 = time.time()
    want = pt.consensus_oracle(mols)
    t_oracle = time.time() - t0
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert got2 == got, "engine is not deterministic"
    log(f"consensus: {len(mols)} molecules byte-equal to the plain oracle: "
        f"{len(bad) == 0} ({len(bad)} differ); engine first {t_first:.2f} s,"
        f" warm {t_warm:.2f} s ({len(mols) / t_warm:.0f} UMIs/s); oracle "
        f"{t_oracle:.2f} s")
    assert not bad, bad[:10]


# ---------------------------------------------------------------------------
# four cards: the data-parallel path vs one card
# ---------------------------------------------------------------------------

def four_cards(seed: int):
    import jax
    from jax.sharding import Mesh

    import __graft_entry__
    from sicelore_tpu.models.readscan import ReadScanModel
    from sicelore_tpu.ops import poa_tpu as pt
    from sicelore_tpu.utils import dna, synth

    devs = require_gpu(4)[:4]
    mesh = Mesh(np.array(devs), ("data",))
    log(f"mesh: 1-D 'data' over {[d.id for d in devs]} ({devs[0].device_kind})")
    log(f"card {card_line()}")
    with phase("sharded-scan"):
        import bench
        rng = np.random.default_rng(seed)
        wl = synth.make_whitelist(rng, FOUR_BARCODES)
        pats, _ = dna.encode_batch([w.encode() for w in wl], 16)
        seqs, quals = bench._make_reads(rng, wl, FOUR_SCAN_READS)
        res = []
        for m in (None, mesh):
            model = ReadScanModel(mesh=m)
            model.prepare_search(pats, len(wl), radius=2)
            h = model.scan_search_async(seqs, quals)
            if m is not None:
                shards = {s.device.id for p in h[0]
                          for s in p.addressable_shards}
                log(f"sharded scan outputs live on devices {sorted(shards)}")
                assert len(shards) == 4, shards
            t0 = time.time()
            out, bc = model.finish_search(model.scan_search_async(seqs,
                                                                  quals))
            log(f"fused scan+search {'4 cards' if m else '1 card'}: "
                f"{time.time() - t0:.3f} s warm")
            res.append((out, bc))
        for k in res[0][1]:
            assert np.array_equal(res[0][1][k], res[1][1][k]), k
        for k, v in res[0][0].items():
            assert np.array_equal(v, res[1][0][k]), k
        log("sharded fused scan+search == one card, byte for byte")
    with phase("mini-e2e"):
        # 2,048 of the dry run's 10,240 reads: its UMI clustering of the
        # read-name X windows (> 32 bases) is scalar host Python and
        # quadratic per cell, not device work
        log("mini e2e cut to 2,048 reads (host-bound clustering)")
        __graft_entry__._dryrun_mini_e2e(4, n_reads=2048)
    with phase("sharded-consensus"):
        mols = consensus_molecules(seed)
        one = pt.BatchedConsensusEngine()(mols)
        four = pt.BatchedConsensusEngine(mesh=mesh)(mols)
        assert one == four, "sharded consensus differs from one card"
        log(f"sharded consensus: {len(mols)} molecules == one card, "
            f"byte for byte")
    return devs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the data-parallel path on 4 cards")
    args = ap.parse_args(argv)

    import jax
    devs = require_gpu(4 if args.four_cards else 1)
    os.environ["SICELORE_NATIVE_BUILD"] = str(NATIVE_BUILD)
    sys.path.insert(0, str(ROOT))
    from sicelore_tpu.utils.jaxcache import enable_compile_cache
    enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    WORK.mkdir(exist_ok=True)
    t0 = time.time()
    if args.four_cards:
        devs = four_cards(args.seed)
        count = 4
    else:
        with phase("device"):
            phase_device()
        with phase("gpu-tests"):
            phase_gpu_tests()
        with phase("kernels"):
            phase_kernels(args.seed)
        with phase("scanfastq"):
            phase_scanfastq(args.seed)
        with phase("run"):
            phase_run(args.seed)
        with phase("consensus"):
            phase_consensus(args.seed)
        count = 1
    for d in devs[:count]:
        log(f"peak device memory {d.id}: "
            f"{d.memory_stats()['peak_bytes_in_use'] / 2**30:.2f} GiB")
    log(f"total wall {time.time() - t0:.1f} s, compile "
        f"{_compile_s[0]:.1f} s")
    log(card_line())
    d = jax.devices()[0]
    log(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
