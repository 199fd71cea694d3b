"""Card-only tests: the Triton kernels as compiled for the GPU (no
interpret mode) against their plain versions, exact. They skip on the
CPU; chip_smoke.py runs them on the card with SICELORE_TEST_GPU=1."""
import jax.numpy as jnp
import numpy as np
import pytest

from sicelore_tpu.ops import bcsearch, editdist
from sicelore_tpu.ops import poa_tpu as pt
from sicelore_tpu.utils import synth

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("track_pos", [False, True])
def test_sweep_kernel_on_card(gpu_device, track_pos):
    rng = np.random.default_rng(1)
    m, W, B, N, nv = 16, 22, 1000, 3000, 2900
    pats = rng.integers(0, 4, (nv, m)).astype(np.int8)
    wins = rng.integers(0, 6, (B, W)).astype(np.int8)
    for i in range(0, B, 2):
        wins[i, 3:3 + m] = pats[int(rng.integers(0, nv))]
    peq = np.zeros((4, N), np.uint32)
    peq[:, :nv] = editdist.build_peq(pats)
    args = (jnp.asarray(wins.T.astype(np.int32)), jnp.asarray(peq),
            jnp.asarray([nv], jnp.int32))
    ker = bcsearch.sweep_top2_triton(*args, m, track_pos=track_pos)
    ref = bcsearch.sweep_top2_ref(*args, m, track_pos=track_pos)
    np.testing.assert_array_equal(np.asarray(ker), np.asarray(ref))


@pytest.mark.parametrize("Lc", [256, 1024])
def test_band_kernels_on_card(gpu_device, Lc):
    rng = np.random.default_rng(Lc)
    W = pt.w_for(Lc)
    PADL = pt.padl_for(W)
    P = 77
    Lrp = ((PADL + Lc + W + 127) // 128) * 128
    cent = np.zeros((Lc, P), np.int8)
    reads = np.full((Lrp, P), 3, np.int8)
    cl = np.zeros(P, np.int32)
    rl = np.zeros(P, np.int32)
    for p in range(P):
        L = int(rng.integers(Lc // 2, Lc + 1))
        t = synth.random_seq(rng, L)
        r = synth.mutate(rng, t, 0.06)[:L + W // 2 - 5]
        cent[:L, p] = [("ACGT").index(c) for c in t]
        reads[PADL:PADL + len(r), p] = [("ACGT").index(c) for c in r]
        cl[p], rl[p] = L, len(r)
    i_row = np.arange(Lrp)[:, None] - W // 2
    rv = np.where((i_row >= 1) & (i_row <= rl[None, :]), reads, 4)
    args = (jnp.asarray(cent), jnp.asarray(rv.astype(np.int8)),
            jnp.asarray(cl), jnp.asarray(rl))
    rec_k, feas_k = pt.band_records_triton(*args, W=W)
    rec_r, feas_r = pt.band_records_ref(*args, W=W)
    np.testing.assert_array_equal(np.asarray(feas_k), np.asarray(feas_r))
    np.testing.assert_array_equal(np.asarray(rec_k), np.asarray(rec_r))


def test_consensus_engine_on_card(gpu_device):
    rng = np.random.default_rng(3)
    mols = []
    for i in range(40):
        t = synth.random_seq(rng, int(rng.integers(200, 1100)))
        mols.append([synth.mutate(rng, t, 0.05).encode()
                     for _ in range(int(rng.integers(1, 7)))])
    assert pt.BatchedConsensusEngine()(mols) == pt.consensus_oracle(mols)
