import numpy as np
import pytest

from sicelore_tpu.ops import editdist
from sicelore_tpu.utils import dna


def random_seqs(rng, n, length):
    return rng.integers(0, 4, size=(n, length)).astype(np.int8)


def mutate(rng, seq, n_sub=0, n_ins=0, n_del=0):
    s = list(seq)
    for _ in range(n_sub):
        i = rng.integers(0, len(s))
        s[i] = (s[i] + rng.integers(1, 4)) % 4
    for _ in range(n_del):
        i = rng.integers(0, len(s))
        del s[i]
    for _ in range(n_ins):
        i = rng.integers(0, len(s) + 1)
        s.insert(i, rng.integers(0, 4))
    return np.array(s, dtype=np.int8)


def test_levenshtein_np_basic():
    assert editdist.levenshtein_np("ACGT", "ACGT") == 0
    assert editdist.levenshtein_np("ACGT", "ACCT") == 1
    assert editdist.levenshtein_np("ACGT", "ACGTT") == 1
    assert editdist.levenshtein_np("ACGT", "AGT") == 1
    assert editdist.levenshtein_np("", "ACGT") == 4
    assert editdist.levenshtein_np("AAAA", "TTTT") == 4
    # N never matches
    assert editdist.levenshtein_np("ANGT", "ANGT") == 1


def test_semiglobal_np_basic():
    ed, pos = editdist.semiglobal_ed_np("ACGT", "TTTTACGTTTT")
    assert ed == 0 and pos == 7
    ed, pos = editdist.semiglobal_ed_np("ACGT", "TTTTACCTTTT")
    assert ed == 1
    ed, pos = editdist.semiglobal_ed_np("AAAA", "CCCCCC")
    assert ed == 4


def test_myers_sweep_vs_np_random():
    rng = np.random.default_rng(0)
    m, W, B, N = 16, 24, 16, 32
    pats = random_seqs(rng, N, m)
    wins = random_seqs(rng, B, W)
    # plant pattern j in window j with a few edits
    for i in range(min(B, N)):
        mutated = mutate(rng, pats[i], n_sub=int(rng.integers(0, 3)))
        off = int(rng.integers(0, W - len(mutated) + 1))
        wins[i, off:off + len(mutated)] = mutated
    peq = editdist.build_peq(pats)
    ed, pos = editdist.myers_sweep(wins, peq, m)
    want, want_pos = editdist.semiglobal_ed_np_batch(pats, wins)
    np.testing.assert_array_equal(np.asarray(ed), want)
    np.testing.assert_array_equal(np.asarray(pos), want_pos)
    # spot-check the batch reference against the scalar reference
    for b, n in [(0, 0), (3, 7), (15, 31)]:
        w, wp = editdist.semiglobal_ed_np(pats[n], wins[b])
        assert want[b, n] == w and want_pos[b, n] == wp


def test_myers_sweep_padding_never_matches():
    pats = dna.encode("ACGTACGTACGTACGT")[None, :]
    peq = editdist.build_peq(pats)
    win = np.full((1, 24), dna.PAD, dtype=np.int8)
    ed, _ = editdist.myers_sweep(win, peq, 16)
    assert int(ed[0, 0]) == 16


def test_best_two():
    ed = np.array([[3, 0, 2, 0], [5, 4, 4, 9]], dtype=np.int32)
    b, i, s, si = editdist.best_two(ed)
    assert b.tolist() == [0, 4]
    assert i.tolist() == [1, 1]
    assert s.tolist() == [0, 4]
    assert si.tolist() == [3, 2]


def test_myers_global_pairwise_vs_np():
    rng = np.random.default_rng(1)
    G, K, m = 2, 8, 12
    texts = np.full((G, K, m + 2), dna.PAD, dtype=np.int8)
    tlens = np.zeros((G, K), dtype=np.int32)
    pats = np.zeros((G, K, m), dtype=np.int8)
    seqs = {}
    for g in range(G):
        base = random_seqs(rng, 1, m)[0]
        for k in range(K):
            s = mutate(rng, base, n_sub=int(rng.integers(0, 3)),
                       n_ins=int(rng.integers(0, 2)), n_del=int(rng.integers(0, 2)))
            seqs[(g, k)] = s
            texts[g, k, :len(s)] = s
            tlens[g, k] = len(s)
            # patterns padded/truncated to m
            p = np.zeros(m, dtype=np.int8)
            p[:min(m, len(s))] = s[:m]
            pats[g, k] = p
    peq_g = np.stack([editdist.build_peq(pats[g]) for g in range(G)])
    ed = np.asarray(editdist.myers_global_pairwise(peq_g, texts, tlens, m))
    for g in range(G):
        for i in range(K):
            for j in range(K):
                want = editdist.levenshtein_np(pats[g, i], seqs[(g, j)])
                assert ed[g, i, j] == want, (g, i, j, ed[g, i, j], want)
