"""Native spliced aligner vs synthetic truth (the minimap2 role)."""
import numpy as np
import pytest

from sicelore_tpu.align import NativeAligner
from sicelore_tpu.align import chain as chainmod
from sicelore_tpu.align import index as idx
from sicelore_tpu.utils import dna, synth


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(100)
    return {"chrT": synth.random_seq(rng, 120_000).encode(),
            "chrU": synth.random_seq(rng, 40_000).encode()}


@pytest.fixture(scope="module")
def aligner(genome):
    return NativeAligner(genome)


def _cig_consumed(rec):
    q = sum(n for op, n in rec.cigar if op in ("M", "I", "S"))
    r = sum(n for op, n in rec.cigar if op in ("M", "D", "N"))
    return q, r


def test_exact_read_maps(aligner, genome):
    pos = 10_000
    read = genome["chrT"][pos:pos + 800]
    rec = aligner.align_batch([b"r1"], [read])[0]
    assert not (rec.flag & 4)
    assert rec.ref_id == 0 and rec.pos == pos
    q, r = _cig_consumed(rec)
    assert q == len(read)
    assert rec.cigar[0][0] in ("M",) and rec.mapq > 10
    m = sum(n for op, n in rec.cigar if op == "M")
    assert m >= len(read) - 40  # ends may soft-clip up to w+k


def test_reverse_strand(aligner, genome):
    pos = 30_000
    read = dna.revcomp_bytes(genome["chrT"][pos:pos + 600])
    rec = aligner.align_batch([b"r2"], [read])[0]
    assert rec.flag & 16
    assert rec.ref_id == 0 and abs(rec.pos - pos) <= 25
    assert rec.seq.encode() == dna.revcomp_bytes(read)  # stored fwd-strand


def test_second_contig(aligner, genome):
    pos = 5_000
    read = genome["chrU"][pos:pos + 500]
    rec = aligner.align_batch([b"r3"], [read])[0]
    assert rec.ref_id == 1 and rec.pos == pos


def test_spliced_read(aligner, genome):
    g = genome["chrT"]
    e1, i1, e2, i2, e3 = 400, 1500, 300, 4000, 350
    s = 50_000
    read = g[s:s + e1] + g[s + e1 + i1:s + e1 + i1 + e2] \
        + g[s + e1 + i1 + e2 + i2:s + e1 + i1 + e2 + i2 + e3]
    rec = aligner.align_batch([b"sp"], [read])[0]
    assert rec.pos == s
    ns = [n for op, n in rec.cigar if op == "N"]
    assert len(ns) == 2, rec.cigar
    assert abs(ns[0] - i1) <= 24 and abs(ns[1] - i2) <= 24, ns
    q, r = _cig_consumed(rec)
    assert q == len(read)
    assert abs(r - (e1 + i1 + e2 + i2 + e3)) <= 48


def test_noisy_reads_map(aligner, genome):
    rng = np.random.default_rng(7)
    g = genome["chrT"]
    names, reads, poss = [], [], []
    for i in range(24):
        pos = int(rng.integers(1000, 100_000))
        frag = g[pos:pos + int(rng.integers(400, 1200))]
        read = synth.mutate(rng, frag.decode(), 0.05).encode()
        if i % 2:
            read = dna.revcomp_bytes(read)
        names.append(b"n%d" % i)
        reads.append(read)
        poss.append(pos)
    recs = aligner.align_batch(names, reads)
    ok = sum(1 for rec, pos in zip(recs, poss)
             if not (rec.flag & 4) and abs(rec.pos - pos) <= 30)
    assert ok >= 22, ok
    for rec, read in zip(recs, reads):
        if not (rec.flag & 4):
            q, _ = _cig_consumed(rec)
            assert q == len(read)
            de = dict((t[0], t[2]) for t in rec.tags)["de"]
            assert 0 <= de < 0.25


def test_garbage_unmapped(aligner):
    rng = np.random.default_rng(8)
    read = synth.random_seq(rng, 700).encode()
    rec = aligner.align_batch([b"g"], [read])[0]
    assert rec.flag & 4


def test_bam_roundtrip_and_exons(aligner, genome, tmp_path):
    """End-to-end: fastq -> sorted BAM+BAI -> own reader -> exon extraction
    (downstream LongreadRecord consumes exactly this)."""
    from sicelore_tpu.io.bam import BamReader
    g = genome["chrT"]
    s, e1, i1, e2 = 20_000, 500, 2000, 400
    read = g[s:s + e1] + g[s + e1 + i1:s + e1 + i1 + e2]
    fq = tmp_path / "in.fastq"
    with open(fq, "wb") as fh:
        fh.write(b"@sp1\n" + read + b"\n+\n" + b"I" * len(read) + b"\n")
        fh.write(b"@plain\n" + g[1000:1600] + b"\n+\n" + b"I" * 600 + b"\n")
    out = tmp_path / "out.bam"
    stats = aligner.align_fastq_to_bam(fq, out)
    assert stats["mapped"] == 2
    rd = BamReader(out)
    recs = list(rd)
    assert [r.pos for r in recs] == sorted(r.pos for r in recs)
    assert (out.with_suffix(".bam.bai").exists()
            or (str(out) + ".bai" and __import__("os").path.exists(
                str(out) + ".bai")))
    sp = [r for r in recs if r.qname == "sp1"][0]
    # exon blocks from the CIGAR (N separates them)
    exons = []
    gpos = sp.pos
    cur = gpos
    for op, n in sp.cigar:
        if op in ("M", "D"):
            gpos += n
        elif op == "N":
            exons.append((cur, gpos))
            gpos += n
            cur = gpos
    exons.append((cur, gpos))
    assert len(exons) == 2
    assert abs(exons[0][0] - s) <= 1
    assert abs(exons[1][1] - (s + e1 + i1 + e2)) <= 24


def test_native_align_full_pipeline(tmp_path):
    """Full workflow with --nativeAlign: scan -> native spliced BAM ->
    assignumis -> isoform matrices, genes/isoforms resolved correctly
    (replaces the minimap2 subprocess end to end)."""
    from sicelore_tpu.pipeline.workflow import run_pipeline
    from sicelore_tpu.utils import synth as sy

    rng = np.random.default_rng(50)
    genome = sy.random_seq(rng, 60_000)
    gene1 = (10_000, 11_200)
    g2e1, g2e2 = (30_000, 30_500), (31_300, 31_900)
    wl = sy.make_whitelist(rng, 12)
    ref = tmp_path / "ref.fa"
    with open(ref, "w") as fh:
        fh.write(">chrS\n")
        for i in range(0, len(genome), 80):
            fh.write(genome[i:i + 80] + "\n")
    rf = tmp_path / "ref.refflat"
    with open(rf, "w") as fh:
        fh.write(f"G1\tT1\tchrS\t+\t{gene1[0]}\t{gene1[1]}\t{gene1[0]}\t"
                 f"{gene1[1]}\t1\t{gene1[0]},\t{gene1[1]},\n")
        fh.write(f"G2\tT2\tchrS\t+\t{g2e1[0]}\t{g2e2[1]}\t{g2e1[0]}\t"
                 f"{g2e2[1]}\t2\t{g2e1[0]},{g2e2[0]},\t"
                 f"{g2e1[1]},{g2e2[1]},\n")
    wlf = tmp_path / "wl.txt"
    wlf.write_text("\n".join(wl))
    fq = tmp_path / "fq"
    fq.mkdir()
    with open(fq / "reads.fastq", "wb") as fh:
        for i in range(400):
            cdna = (genome[gene1[0]:gene1[1]] if i % 2 == 0 else
                    genome[g2e1[0]:g2e1[1]] + genome[g2e2[0]:g2e2[1]])
            umi = sy.random_seq(rng, 12)
            stranded = (sy.TSO + cdna + "A" * 20 + dna.revcomp_str(umi)
                        + dna.revcomp_str(wl[i % 12])
                        + dna.revcomp_str(sy.ADAPTER))
            stranded = sy.mutate(rng, stranded, 0.04)
            seq = (dna.revcomp_str(stranded) if i % 3 == 0
                   else stranded).encode()
            fh.write(b"@rd%d\n" % i + seq + b"\n+\n" + b"I" * len(seq)
                     + b"\n")
    out = tmp_path / "out"
    run_pipeline(fq, ref, rf, out, whitelist=wlf, bc_ed=2,
                 native_align=True, log=lambda *a: None)
    rows = (out / "isomatrix" / "sicelore_genematrix.txt"
            ).read_text().splitlines()
    hdr = rows[0].split("\t")[1:]
    mat = {r.split("\t")[0]: list(map(int, r.split("\t")[1:]))
           for r in rows[1:]}
    assert set(mat) == {"G1", "G2"}
    even = {wl[i] for i in range(0, 12, 2)}
    for g, want in (("G1", even), ("G2", set(wl) - even)):
        got = {bc for bc, c in zip(hdr, mat[g]) if c > 0}
        assert got == want, (g, got)
    iso = (out / "isomatrix" / "sicelore_isomatrix.txt").read_text()
    assert "\tT1\t1\t" in iso and "\tT2\t2\t" in iso


def test_junc_bed_snapping(genome, tmp_path):
    """Annotated junctions (--junc-bed role) override motif snapping: the
    N op takes the exact annotated intron."""
    g = genome["chrT"]
    s, e1, e2 = 70_000, 420, 380
    intron_start, intron_len = s + e1, 2517
    read = g[s:intron_start] + g[intron_start + intron_len:
                                 intron_start + intron_len + e2]
    bed = tmp_path / "junc.bed"
    bed.write_text(f"chrT\t{intron_start}\t{intron_start + intron_len}\tj1\n")
    al = NativeAligner(genome, junc_bed=bed)
    rec = al.align_batch([b"jb"], [read])[0]
    ns = [(op, n) for op, n in rec.cigar if op == "N"]
    assert ns == [("N", intron_len)], rec.cigar
    # exact junction position: ref consumed before N equals e1
    before = 0
    for op, n in rec.cigar:
        if op == "N":
            break
        if op in ("M", "D"):
            before += n
    assert rec.pos + before == intron_start


def test_md_tag(genome):
    """MD:Z must reconstruct the reference over aligned columns (SAMtags
    spec): validated by regenerating the ref M/D bases from query + MD."""
    import re
    g = genome["chrT"]
    rng = np.random.default_rng(5)
    s = 50_000
    read = bytearray(g[s:s + 800])
    for p in (100, 333, 507):   # substitutions
        read[p] = b"ACGT"[(b"ACGT".index(read[p:p + 1]) + 1) % 4]
    read = bytes(read)
    al = NativeAligner(genome)
    rec = al.align_batch([b"md"], [read])[0]
    md = next(v for t, ty, v in rec.tags if t == "MD")
    # reconstruct ref from query + CIGAR + MD and compare to the genome
    qpos = 0
    ref = bytearray()
    qaln = bytearray()
    for op, n in rec.cigar:
        if op in ("S",):
            qpos += n
        elif op == "I":
            qpos += n
        elif op == "M":
            qaln += rec.seq[qpos:qpos + n].encode()
            qpos += n
        elif op in ("D", "N"):
            pass
    toks = re.findall(r"(\d+)|(\^[A-Z]+)|([A-Z])", md)
    qi = 0
    for num, dele, sub in toks:
        if num:
            k = int(num)
            ref += qaln[qi:qi + k]
            qi += k
        elif sub:
            ref += sub.encode()
            qi += 1
        # deletions consume no query-aligned bases
    truth = g[rec.pos:rec.pos + len(ref)]
    # ref bases at N gaps are skipped in both reconstructions
    assert bytes(ref[:200]) == truth[:200]
    nm = next(v for t, ty, v in rec.tags if t == "NM")
    assert nm >= 3


def test_supplementary_chimera(genome):
    """A fusion read (two distant loci) must emit a primary + a
    FLAG 0x800 supplementary record with reciprocal SA tags."""
    read = (genome["chrT"][20_000:20_900]
            + genome["chrU"][20_000:20_900])
    al = NativeAligner(genome)
    recs = al.align_batch([b"fus"], [read])
    assert len(recs) >= 2, [r.flag for r in recs]
    prim = [r for r in recs if not (r.flag & 0x900)]
    supp = [r for r in recs if r.flag & 0x800]
    assert len(prim) == 1 and len(supp) >= 1, [r.flag for r in recs]
    sa_p = next(v for t, ty, v in prim[0].tags if t == "SA")
    sa_s = next(v for t, ty, v in supp[0].tags if t == "SA")
    assert sa_p.endswith(";") and sa_s.endswith(";")
    # the two parts land on different contigs
    assert {prim[0].ref_id, supp[0].ref_id} == {0, 1}


def test_index_save_load(genome, tmp_path):
    """Index serialization round-trips and aligns identically."""
    from sicelore_tpu.align import index as idx
    mi = idx.MinimizerIndex(genome)
    f = tmp_path / "ref.npz"
    mi.save(f)
    m2 = idx.MinimizerIndex.load(f)
    assert (m2.h == mi.h).all() and (m2.p == mi.p).all()
    al1 = NativeAligner(genome)
    al2 = NativeAligner.__new__(NativeAligner)
    al2.index = m2
    al2.k = m2.k
    al2.junctions = {}
    g = genome["chrT"]
    read = g[10_000:10_700]
    r1 = al1.align_batch([b"x"], [read])[0]
    r2 = al2.align_batch([b"x"], [read])[0]
    assert (r1.pos, r1.cigar) == (r2.pos, r2.cigar)
