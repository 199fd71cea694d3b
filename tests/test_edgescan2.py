"""Two-half text-major edge scan vs the round-3 contiguous-composite scan.

The two-half layout (ops.edgescan) must reproduce the contiguous scan's
results exactly for every read whose end evidence lies within E bases of
that end (the standard case; the documented divergence is >140 bp polyA
runs on sub-2E reads, which the generator here never emits)."""
import numpy as np
import pytest

from sicelore_tpu.models import readscan
from sicelore_tpu.ops import edgescan
from sicelore_tpu.utils import synth
from sicelore_tpu.utils.config import PipelineConfig


def _reads(rng, n, with_long=True):
    wl = synth.make_whitelist(rng, 48)
    seqs, quals = [], []
    for i in range(n):
        if with_long and i % 7 == 3:
            clen = int(rng.integers(1200, 4000))   # > 2E: spliced composite
        elif i % 5 == 2:
            clen = int(rng.integers(40, 260))      # short: overlapping halves
        else:
            clen = int(rng.integers(260, 560))
        r = synth.make_read(rng, wl[i % 48], cdna_len=clen,
                            error_rate=0.05, reverse=bool(i % 2))
        seqs.append(r["seq"])
        quals.append(r["qual"])
    # garbage + unstranded + N-free oddballs
    for L in (15, 200, 400, 700):
        s = synth.random_seq(rng, L).encode()
        seqs.append(s)
        quals.append(bytes([33 + int(x) for x in rng.integers(3, 40, L)]))
    return seqs, quals


def _new_scan(cfg, seqs, quals):
    import jax.numpy as jnp
    packed, qv2, lens, dirty, qsum = edgescan.encode_composite_tm(seqs, quals)
    assert not dirty.any()
    body = edgescan.make_edge_scan2_packed(cfg)
    model = readscan.ReadScanModel(cfg)
    meta = np.asarray(body(jnp.asarray(packed), model.peq_ad,
                           model.peq_adc, model.peq_tso))
    out = edgescan.finalize_meta_np(meta, lens, cfg)
    edgescan.compute_qvs2_np(qv2, lens, out,
                             cfg.barcodes.cell_bc_length,
                             cfg.chemistry == "5p", qsum)
    return out


KEYS = ("is_fwd", "stranded", "has_polyat", "ps", "pe", "ae", "adapter_ed",
        "adapter_complete_ed", "adapter_run", "tso_end", "tso_ed",
        "x_start", "x_end")


@pytest.mark.parametrize("chem", ["3p", "5p"])
def test_two_half_matches_contiguous(chem):
    rng = np.random.default_rng(11)
    cfg = PipelineConfig()
    cfg.chemistry = chem
    seqs, quals = _reads(rng, 120)
    model = readscan.ReadScanModel(cfg)
    old = model.scan_reads(seqs, quals)
    new = _new_scan(cfg, seqs, quals)
    for k in KEYS:
        ov, nv = np.asarray(old[k]), np.asarray(new[k])
        mism = np.nonzero(ov != nv)[0]
        assert len(mism) == 0, (k, mism[:5], ov[mism[:5]], nv[mism[:5]],
                                [len(seqs[i]) for i in mism[:5]])
    assert np.array_equal(old["bc_windows"], new["bc_windows"])
    for k in ("read_qv", "x_qv", "bc_qv"):
        assert np.allclose(old[k], new[k], atol=1e-4), k


def test_kmer_rows_match_windows():
    rng = np.random.default_rng(12)
    cfg = PipelineConfig()
    seqs, quals = _reads(rng, 40, with_long=False)
    new = _new_scan(cfg, seqs, quals)
    pad = cfg.readscanner.test_plus_minus_pos
    m = cfg.barcodes.cell_bc_length
    wins = new["bc_windows"][:, pad:pad + m].astype(np.int64)
    valid = (wins < 4).all(axis=1)
    assert np.array_equal(valid, new["bc_kmer_valid"])
    kmer = np.zeros(len(seqs), np.int64)
    for i in range(m):
        kmer = (kmer << 2) | np.minimum(wins[:, i], 3)
    assert np.array_equal(kmer[valid],
                          new["bc_kmer"][valid].astype(np.int64))


def test_tso_bailout_accepts_partial_tso():
    """A TSO with >maxNeedlemanMismatches errors but an exact >=8-base
    consecutive run must still report T= (config.xml:160-166 bailout)."""
    import jax.numpy as jnp
    cfg = PipelineConfig()
    rng = np.random.default_rng(5)
    wl = synth.make_whitelist(rng, 4)
    r = synth.make_read(rng, wl[0], cdna_len=400, error_rate=0.0)
    seq = bytearray(r["seq"])  # FWD read, TSO at the 5' start
    # the read begins with the TSO (sense); scramble its tail so ed > 5
    # while the first 9 bases stay an exact run
    tso = cfg.tso3p.sequence.encode()
    assert bytes(seq[:len(tso)]) == tso
    # keep the first 9 TSO bases (an exact run >= c1=8), then flood the
    # rest of the 90-base TSO window with C so no cheap chance alignment
    # exists (over a random 90-mer the min semi-global ED of a 16-mer is
    # ~5 by chance alone, which is why the bailout is a rare-fire path)
    seq[9:cfg.tso3p.window_for_tso_search] = (
        b"C" * (cfg.tso3p.window_for_tso_search - 9))
    seqs = [bytes(seq)]
    quals = [r["qual"]]
    out = _new_scan(cfg, seqs, quals)
    assert out["stranded"][0] and out["is_fwd"][0]
    assert out["tso_ed"][0] > cfg.tso3p.max_needleman_mismatches
    assert out["tso_end"][0] >= 0  # bailout accepted it
