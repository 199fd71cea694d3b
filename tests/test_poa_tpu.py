"""Batched device consensus engine vs the jnp oracle, host engine, truth."""
import jax.numpy as jnp
import numpy as np
import pytest

from sicelore_tpu.ops import poa
from sicelore_tpu.ops import poa_tpu as pt
from sicelore_tpu.ops.editdist import levenshtein_np
from sicelore_tpu.ops.poa_tpu import BatchedConsensusEngine
from sicelore_tpu.utils import dna, synth


@pytest.fixture(scope="module")
def engine():
    return BatchedConsensusEngine()


def _mols(rng, n_mol, depth, rate, length):
    mols, truths = [], []
    for _ in range(n_mol):
        truth = synth.random_seq(rng, length)
        mols.append([synth.mutate(rng, truth, rate).encode()
                     for _ in range(depth)])
        truths.append(truth)
    return mols, truths


def test_device_engine_accuracy(engine):
    rng = np.random.default_rng(0)
    mols, truths = _mols(rng, 6, 8, 0.08, 500)
    res = engine(mols)
    for (cons, qv), truth, reads in zip(res, truths, mols):
        assert len(cons) == len(qv)
        ed = levenshtein_np(cons.decode(), truth)
        read_ed = np.mean([levenshtein_np(r.decode(), truth) for r in reads])
        assert ed < 0.3 * read_ed, (ed, read_ed)


def test_device_vs_host_equivalence(engine):
    """Device consensus must closely match the host center-star engine."""
    rng = np.random.default_rng(1)
    mols, truths = _mols(rng, 4, 6, 0.06, 400)
    dev = engine(mols)
    for (dc, dq), seqs, truth in zip(dev, mols, truths):
        hc, hq = poa.consensus_reads(seqs)
        # identical algorithms modulo banding/tie-breaks: small divergence
        assert levenshtein_np(dc.decode(), hc.decode()) <= 0.01 * len(hc) + 3


def test_device_engine_dispatch(engine):
    """1/2-read molecules short-circuit exactly like the reference."""
    res = engine([[b"ACGTACGTAA"],
                  [b"ACGTACGTAA", b"ACGTACGTAAACG"],
                  [b"ACGT" * 50] * 4])
    assert res[0][0] == b"ACGTACGTAA"
    assert res[1][0] == b"ACGTACGTAAACG"
    assert res[2][0] == b"ACGT" * 50
    assert res[2][1] == bytes([53]) * 200  # full agreement -> 33+20


def _dev_vs_oracle(mols, engine=None):
    """Byte-equality of the device route (band_align + votes_assemble) vs
    the plain oracle (consensus_votes + _assemble)."""
    rd = (engine or BatchedConsensusEngine())(mols)
    ro = pt.consensus_oracle(mols)
    for i, ((dc, dq), (oc, oq)) in enumerate(zip(rd, ro)):
        assert dc == oc, (i, dc, oc)
        assert dq == oq, (i, dq, oq)
    return rd


def test_band_align_parity_w32():
    """band_align + votes_assemble == consensus_votes + _assemble over
    randomized molecules in the W=32 bucket (Lc <= 512), including >K_INS
    insertion runs, deletions, near-band-edge length diffs, and a center
    exactly at the bucket size."""
    rng = np.random.default_rng(7)
    mols, _ = _mols(rng, 5, 5, 0.08, 220)
    # heavy-indel molecules: insertion runs longer than K_INS
    for _ in range(3):
        truth = synth.random_seq(rng, 200)
        reads = []
        for r in range(4):
            pos = int(rng.integers(40, 160))
            ins = synth.random_seq(rng, int(rng.integers(6, 11)))
            s = truth[:pos] + ins + truth[pos:]
            dpos = int(rng.integers(20, 120))
            s = s[:dpos] + s[dpos + int(rng.integers(1, 9)):]
            reads.append(synth.mutate(rng, s, 0.03).encode())
        mols.append(reads)
    # near-band-edge length diffs (W//2 - 4 = 12 is the drop threshold)
    truth = synth.random_seq(rng, 240)
    mols.append([truth.encode(), truth[:229].encode(), (truth + "ACGTACGTACG").encode(),
                 synth.mutate(rng, truth, 0.05).encode()])
    # center exactly at the bucket boundary (Lc == clen == 256)
    truth = synth.random_seq(rng, 256)
    mols.append([synth.mutate(rng, truth, 0.04).encode() for _ in range(4)]
                + [truth.encode()])
    _dev_vs_oracle(mols)


def test_band_align_parity_w64():
    """Same parity in the W=64 bucket (Lc > 512)."""
    rng = np.random.default_rng(8)
    mols, _ = _mols(rng, 2, 4, 0.06, 560)
    truth = synth.random_seq(rng, 600)
    reads = []
    for r in range(5):
        pos = int(rng.integers(100, 500))
        s = truth[:pos] + synth.random_seq(rng, 7) + truth[pos:]
        reads.append(synth.mutate(rng, s, 0.04).encode())
    mols.append(reads)
    _dev_vs_oracle(mols)


def test_mixed_length_buckets(engine):
    rng = np.random.default_rng(2)
    mols1, t1 = _mols(rng, 2, 5, 0.05, 200)
    mols2, t2 = _mols(rng, 2, 5, 0.05, 1500)
    res = engine(mols1 + mols2)
    for (cons, _), truth in zip(res, t1 + t2):
        assert levenshtein_np(cons.decode(), truth) < 0.05 * len(truth)


def test_refine_pass():
    """refine=True re-centers on the pass-1 consensus and must not hurt
    identity; 1/2-read molecules keep short-circuiting."""
    rng = np.random.default_rng(9)
    eng = BatchedConsensusEngine()
    mols, truths = _mols(rng, 4, 8, 0.09, 300)
    mols.append([b"ACGTACGTAA"])
    r1 = eng(mols)
    r2 = eng(mols, refine=True)
    assert r2[-1][0] == b"ACGTACGTAA"
    for (c1, _), (c2, _), t in zip(r1, r2, truths):
        d1 = levenshtein_np(c1.decode(), t)
        d2 = levenshtein_np(c2.decode(), t)
        assert d2 <= d1 + 2, (d1, d2)


def test_sharded_band_align_parity():
    """The multi-device consensus route (pairs sharded over a 4-device
    mesh, votes psum-merged, device assembly — parallel/consensus_step)
    must be byte-identical to one device and to the plain oracle."""
    import jax
    from jax.sharding import Mesh

    rng = np.random.default_rng(11)
    mols = []
    for i in range(12):
        t = synth.random_seq(rng, int(rng.integers(150, 250)))
        mols.append([synth.mutate(rng, t, 0.05).encode() for _ in range(4)])
    # a >K_INS insertion run crossing shard boundaries
    t = synth.random_seq(rng, 200)
    mols.append([(t[:80] + synth.random_seq(rng, 7) + t[80:]).encode()
                 for _ in range(3)] + [t.encode()])
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    r_1c = _dev_vs_oracle(mols)
    r_sh = BatchedConsensusEngine(mesh=mesh)(mols)
    assert r_sh == r_1c


def _pairs(rng, Lc, P, err):
    """Random (center, read) pairs in band_records' text-major layout."""
    W = pt.w_for(Lc)
    PADL = pt.padl_for(W)
    Lrp = ((PADL + Lc + W + 127) // 128) * 128
    cent = np.zeros((Lc, P), np.int8)
    reads = np.full((Lrp, P), 3, np.int8)
    cl = np.zeros(P, np.int32)
    rl = np.zeros(P, np.int32)
    for p in range(P):
        L = int(rng.integers(Lc // 2, Lc + 1))
        t = synth.random_seq(rng, L)
        r = synth.mutate(rng, t, err)[:Lc + W]
        if abs(len(r) - L) >= W // 2 - 4:
            r = t
        if p % 3 == 1:          # lengths near the band edge
            r = (r + synth.random_seq(rng, W // 2))[:L + W // 2 - 5]
        cent[:L, p] = dna.encode(t)
        reads[PADL:PADL + len(r), p] = dna.encode(r)
        cl[p], rl[p] = L, len(r)
    i_row = np.arange(Lrp)[:, None] - W // 2
    rv = np.where((i_row >= 1) & (i_row <= rl[None, :]), reads, 4)
    return W, (jnp.asarray(cent), jnp.asarray(rv.astype(np.int8)),
               jnp.asarray(cl), jnp.asarray(rl))


@pytest.mark.parametrize("Lc,P", [(256, 37), (1024, 5)])
def test_band_records_triton_interpret(Lc, P, pallas_interpret):
    """The Triton band-alignment kernels (Pallas interpret mode) emit the
    plain version's walk records and feasibility exactly, at W=32 and
    W=64, with a pair count that is not a multiple of the pair block."""
    W, args = _pairs(np.random.default_rng(Lc), Lc, P, 0.08)
    rec_r, feas_r = pt.band_records_ref(*args, W=W)
    rec_t, feas_t = pt.band_records_triton(*args, W=W)
    assert rec_t.shape == (P, Lc + 1)
    np.testing.assert_array_equal(np.asarray(feas_t), np.asarray(feas_r))
    np.testing.assert_array_equal(np.asarray(rec_t), np.asarray(rec_r))
    assert np.asarray(feas_r).sum() > 0
