import jax.numpy as jnp
import numpy as np
import pytest

from sicelore_tpu.ops import bcsearch, editdist


def test_bc_search_sweep_path():
    rng = np.random.default_rng(2)
    m, W, B, N = 16, 22, 64, 100
    pats = rng.integers(0, 4, size=(N, m)).astype(np.int8)
    wins = rng.integers(0, 4, size=(B, W)).astype(np.int8)
    # plant barcode i at offset 3 in window i (exact)
    for i in range(min(B, N)):
        wins[i, 3:3 + m] = pats[i]
    peq = editdist.build_peq(pats)
    res = bcsearch.bc_search(wins, peq, N, m)
    for i in range(min(B, N)):
        assert res["ed"][i] == 0
        assert res["idx"][i] == i
        assert res["end_pos"][i] == 3 + m - 1


def _case(seed, B, N, n_valid, m=16, W=22):
    rng = np.random.default_rng(seed)
    pats = rng.integers(0, 4, size=(n_valid, m)).astype(np.int8)
    wins = rng.integers(0, 6, size=(B, W)).astype(np.int8)   # N/PAD too
    for i in range(B):
        j = int(rng.integers(0, n_valid))
        wins[i, 2:2 + m] = pats[j]
        if i % 3 == 0:                  # one substitution: ED 1 matches
            wins[i, 7] = (wins[i, 7] + 1) % 4
    peq = np.zeros((4, N), dtype=np.uint32)
    peq[:, :n_valid] = editdist.build_peq(pats)
    return pats, wins, peq


@pytest.mark.parametrize("track_pos", [False, True])
def test_sweep_triton_interpret_matches_ref(track_pos, pallas_interpret):
    """The Triton sweep kernel (Pallas interpret mode) == the plain sweep,
    over several read and barcode tiles, a ragged last barcode tile and
    masked padding lanes."""
    m = 16
    pats, wins, peq = _case(3, B=24, N=200, n_valid=190)
    args = (jnp.asarray(wins.T.astype(np.int32)), jnp.asarray(peq),
            jnp.asarray([190], dtype=np.int32))
    ref = np.asarray(bcsearch.sweep_top2_ref(*args, m, track_pos=track_pos))
    tri = np.asarray(bcsearch.sweep_top2_triton(
        *args, m, track_pos=track_pos, bt=8, nt=64))
    np.testing.assert_array_equal(tri, ref)


def test_sweep_ref_matches_scalar_oracle():
    """The plain sweep's best/argmin/second/end position == the numpy
    semi-global DP, including the sliced path (B > REF_SLICE)."""
    m = 16
    pats, wins, peq = _case(4, B=2 * bcsearch.REF_SLICE, N=24, n_valid=24)
    out = np.asarray(bcsearch.sweep_top2_ref(
        jnp.asarray(wins.T.astype(np.int32)), jnp.asarray(peq),
        jnp.asarray([24], dtype=np.int32), m, track_pos=True))
    sel = np.r_[0:40, bcsearch.REF_SLICE:bcsearch.REF_SLICE + 40]
    ed, pos = editdist.semiglobal_ed_np_batch(pats, wins[sel])
    idx = ed.argmin(axis=1)
    np.testing.assert_array_equal(out[0, sel], ed.min(axis=1))
    np.testing.assert_array_equal(out[1, sel], idx)
    masked = ed.copy()
    masked[np.arange(len(sel)), idx] = bcsearch.BIG
    np.testing.assert_array_equal(out[2, sel], masked.min(axis=1))
    np.testing.assert_array_equal(out[3, sel], pos[np.arange(len(sel)), idx])


def test_sweep_triton_pads_reads_and_barcodes(pallas_interpret):
    """The kernel wrapper pads B to the read tile, N to the barcode tile
    and W to a power of two, and slices the padding back off."""
    m = 16
    pats, wins, peq = _case(5, B=13, N=70, n_valid=70)
    args = (jnp.asarray(wins.T.astype(np.int32)), jnp.asarray(peq),
            jnp.asarray([70], dtype=np.int32))
    tri = bcsearch.sweep_top2_triton(*args, m, bt=8, nt=64)
    assert tri.shape == (4, 13)
    np.testing.assert_array_equal(
        np.asarray(tri), np.asarray(bcsearch.sweep_top2_ref(*args, m)))


def test_bc_search_second_best_sentinel():
    # single barcode -> ed2 must be INT_MAX like the reference's ed_sec
    pats = np.zeros((1, 16), dtype=np.int8)
    wins = np.zeros((4, 20), dtype=np.int8)
    peq = editdist.build_peq(pats)
    res = bcsearch.bc_search(wins, peq, 1, 16)
    assert (res["ed2"] == editdist.INT_MAX).all()
    assert (res["ed"] == 0).all()
