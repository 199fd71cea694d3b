"""Golden tests against the REAL gencode.v38.chr12.refFlat shipped with the
reference (/root/reference/Data/gencode.v38.chr12.refFlat) — the quickrun
dataset's annotation (reference README.md:58: hg38 chr12 Myl6 locus).

These are the first tests touching real annotation rather than synthetic
fixtures: refFlat parsing, gene-model selection, the
LocusFunction tagger and STRICT isoform assignment all run on real
transcript structures (MYL6 / MYL6B, utils/UCSCRefFlatParser.java:92-164).
"""
from pathlib import Path

import numpy as np
import pytest

REFFLAT = Path("/root/reference/Data/gencode.v38.chr12.refFlat")

pytestmark = pytest.mark.skipif(not REFFLAT.exists(),
                                reason="reference refFlat not present")


@pytest.fixture(scope="module")
def model():
    from sicelore_tpu.core.refflat import RefFlatModel
    return RefFlatModel.load(REFFLAT)


def test_parse_real_refflat(model):
    # gencode v38 chr12: thousands of genes incl. the quickrun locus
    assert len(model.by_gene) > 1000
    assert "MYL6" in model.by_gene and "GAPDH" in model.by_gene
    txs = model.by_gene["MYL6"]
    assert len(txs) >= 5
    t = {x.transcript_id.split(".")[0]: x for x in txs}
    # MYL6 canonical transcript: 7 exons, chr12 '-' strand (gencode v38)
    canon = t.get("ENST00000547034") or txs[0]
    assert canon.chrom == "chr12"
    assert all(x.strand == txs[0].strand for x in txs)
    for x in txs:
        assert x.n_exons == len(x.exons)
        assert x.junctions.shape == (max(x.n_exons - 1, 0), 2)
        # exons 1-based ascending, junction gaps positive
        for (s, e) in x.exons:
            assert 0 < s <= e
        if len(x.junctions):
            assert (x.junctions[:, 1] > x.junctions[:, 0]).all()


def test_strict_isoform_on_real_myl6(model):
    """Synthetic reads placed EXACTLY on a real MYL6 transcript's junctions
    must STRICT-assign to it; off-by->delta junctions must not."""
    from sicelore_tpu.core.molecule import Molecule
    from sicelore_tpu.core.longread import Longread, LongreadRecord

    txs = model.by_gene["MYL6"]
    multi = [t for t in txs if len(t.junctions) >= 3]
    assert multi
    target = multi[0]

    def mol_with_junctions(juncs):
        rec = LongreadRecord()
        rec.name = b"m1"
        rec.barcode = "ACGTACGTACGTACGT"
        rec.umi = "AAACCCGGGTTT"
        rec.gene_id = "MYL6"
        rec.rn = 1
        rec.de = 0.1
        rec.junctions = np.asarray(juncs, dtype=np.int64).reshape(-1, 2)
        lr = Longread("m1")
        lr.add(rec)
        lr.records.append(rec)
        m = Molecule("ACGTACGTACGTACGT", "AAACCCGGGTTT")
        m.add_longread(lr)
        return m

    class DS:
        pass

    from sicelore_tpu.core.molecule import MoleculeDataset
    ds = MoleculeDataset.__new__(MoleculeDataset)
    ds.model = model
    from sicelore_tpu.core.molecule import IsoformStats
    ds.stats = IsoformStats()
    rng = np.random.default_rng(0)

    m = mol_with_junctions(target.junctions + 1)  # within delta=2
    ds._set_isoform_strict(m, 2, rng)
    assert m.transcript_id == target.transcript_id

    m2 = mol_with_junctions(target.junctions + 10)  # beyond delta
    ds._set_isoform_strict(m2, 2, rng)
    assert m2.transcript_id in (None, "undef")


def test_locusfunction_on_real_gene(model):
    """GeneTagger on the real annotation: an exonic block inside MYL6 gets
    GE=MYL6 on the right strand and loses GE (keeps XF) antisense."""
    from sicelore_tpu.core.genetag import GeneTagger

    tagger = GeneTagger(model)
    tx = max(model.by_gene["MYL6"], key=lambda t: t.n_exons)
    s, e = tx.exons[1]
    ge, gs, xf = tagger.annotate("chr12", [(s, min(e, s + 30))], tx.strand)
    assert ge is not None and "MYL6" in ge.split(",")
    assert gs is not None and tx.strand in gs.split(",")
    assert xf in ("CODING", "UTR")
    anti = "-" if tx.strand == "+" else "+"
    ge2, gs2, xf2 = tagger.annotate("chr12", [(s, min(e, s + 30))], anti)
    assert ge2 is None and xf2 in ("CODING", "UTR")
    # intergenic far upstream of everything on chr12
    ge3, _, xf3 = tagger.annotate("chr12", [(5, 10)], "+")
    assert ge3 is None and xf3 == "INTERGENIC"
