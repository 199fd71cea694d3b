"""Cell-barcode whitelist search: fused Myers sweep + top-2 reduction.

The hot loop of the reference's read scan is the per-read barcode
edit-distance search (jar BarcodeMatchTester/BCnucTwoBitPerBaseEDtester:
enumerate ED-neighborhood of the read's BC window, probe a hash set, track
best + second-best ED). Here: a [reads x barcodes] Myers bit-parallel sweep
whose only useful output is four numbers per read (best ED, its barcode
index, second-best ED, end position of the best match).

Two implementations of one contract (`sweep_top2`):

  * `sweep_top2_ref` — plain jnp: the text loop as a partly unrolled scan
    so XLA fuses several characters per step, then the masked top-2 over
    the barcode axis. It runs on every backend and is the oracle of the
    kernel.
  * `sweep_top2_triton` — a Pallas kernel through Triton for the GPU. Each
    program owns a block of reads, keeps the Myers state of one barcode
    tile in registers for the whole window, and folds the tile's top-2
    into a running best/second carried across the barcode tiles inside the
    program, so the [B, N] state never reaches device memory: it reads the
    windows and the pattern bitmasks and writes [4, B].

`sweep_top2` lowers the kernel on CUDA and the plain version elsewhere
(`jax.lax.platform_dependent`), so CPU tests run the reference and the
GPU runs the kernel from the same call site.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from sicelore_tpu.ops import editdist

BIG = 2**30  # sentinel for masked lanes (avoids int32 overflow in +1)
REF_SLICE = 2048   # reads per plain-sweep block: bounds the [S, N] state
REF_UNROLL = 4     # window characters fused per plain-sweep loop step
BT, NT = 16, 128   # kernel tile: reads per program x barcodes per step
NUM_WARPS = 4


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _full_mask(m: int):
    return jnp.uint32((1 << m) - 1) if m < 32 else jnp.uint32(0xFFFFFFFF)


def _myers_init(m: int, shape):
    z = jnp.zeros(shape, jnp.uint32)
    score = jnp.full(shape, m, jnp.int32)
    return (z + _full_mask(m), z, score, score,
            jnp.full(shape, -1, jnp.int32))


def _myers_step(state, wc, peqs, t, m: int, track_pos: bool):
    """One text character of the semi-global Myers sweep. state = (PV, MV,
    score, best, bestpos); wc and the 4 pattern bitmask rows `peqs`
    broadcast to the state shape; t is the text position."""
    PV, MV, score, best, bestpos = state
    hibit = jnp.uint32(m - 1)
    z = jnp.zeros_like(PV)
    eq = jnp.where(wc == 0, peqs[0] + z,
          jnp.where(wc == 1, peqs[1] + z,
           jnp.where(wc == 2, peqs[2] + z,
            jnp.where(wc == 3, peqs[3] + z, z))))
    Xv = eq | MV
    Xh = (((eq & PV) + PV) ^ PV) | eq
    Ph = MV | ~(Xh | PV)
    Mh = PV & Xh
    score = score + ((Ph >> hibit) & jnp.uint32(1)).astype(jnp.int32)
    score = score - ((Mh >> hibit) & jnp.uint32(1)).astype(jnp.int32)
    Ph = Ph << jnp.uint32(1)  # free text start (search variant)
    Mh = Mh << jnp.uint32(1)
    PV = Mh | ~(Xv | Ph)
    MV = Ph & Xv
    if track_pos:
        bestpos = jnp.where(score < best, t, bestpos)
    return PV, MV, score, jnp.minimum(score, best), bestpos


def _top2(ed, gidx, bestpos, track_pos: bool):
    """Per row over axis 1: best, first argmin, second best (the argmin
    lane excluded), end position at the argmin (-1 without tracking)."""
    b1 = jnp.min(ed, axis=1)
    i1 = jnp.min(jnp.where(ed == b1[:, None], gidx, BIG), axis=1)
    b2 = jnp.min(jnp.where(gidx == i1[:, None], BIG, ed), axis=1)
    if not track_pos:     # skip a reduction over a constant -1 array
        return b1, i1, b2, jnp.full_like(b1, -1)
    pos = jnp.max(jnp.where(gidx == i1[:, None], bestpos, -1), axis=1)
    return b1, i1, b2, pos


def _sweep_block_ref(wins_tm, peq, nvalid, m: int, track_pos: bool):
    W, S = wins_tm.shape
    N = peq.shape[1]
    peqs = [peq[c][None, :] for c in range(4)]

    def step(state, x):
        wc, t = x
        return _myers_step(state, wc[:, None], peqs, t, m, track_pos), None

    # a partly unrolled scan: XLA fuses REF_UNROLL characters per loop
    # step; a fully unrolled 22-step chain makes XLA's compile time blow
    # up (the fused expression duplicates shared producers)
    (_, _, _, best, bestpos), _ = jax.lax.scan(
        step, _myers_init(m, (S, N)),
        (wins_tm, jnp.arange(W, dtype=jnp.int32)), unroll=REF_UNROLL)
    gidx = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (S, N))
    ed = jnp.where(gidx < nvalid[0], best, BIG)
    return jnp.stack(_top2(ed, gidx, bestpos, track_pos), axis=0)


@functools.partial(jax.jit, static_argnames=("m", "track_pos"))
def sweep_top2_ref(windows_tm: jax.Array, peq: jax.Array, nvalid: jax.Array,
                   m: int, track_pos: bool = False):
    """Plain jnp sweep. windows_tm [W, B] int (codes; PAD/N never match),
    peq [4, N] uint32, nvalid [1] int32 -> [4, B] int32 rows best_ed,
    best_idx (lowest index on ties), second_ed (BIG when none), best end
    position (-1 unless track_pos). Reads run in REF_SLICE blocks so the
    [block, N] state stays bounded at any B."""
    W, B = windows_tm.shape
    wins = windows_tm.astype(jnp.int32)
    if B <= REF_SLICE or B % REF_SLICE:
        return _sweep_block_ref(wins, peq, nvalid, m, track_pos)
    C = B // REF_SLICE
    blocks = jnp.transpose(wins.reshape(W, C, REF_SLICE), (1, 0, 2))
    out = jax.lax.map(
        lambda w: _sweep_block_ref(w, peq, nvalid, m, track_pos), blocks)
    return jnp.transpose(out, (1, 0, 2)).reshape(4, B)


def _sweep_kernel(nv_ref, win_ref, peq_ref, out_ref, *, m: int, W: int,
                  nt: int, n_tiles: int, track_pos: bool):
    """One block of reads against the whole (padded) barcode list."""
    bt = out_ref.shape[1]
    nvalid = nv_ref[0]
    wcs = [win_ref[t, :][:, None] for t in range(W)]        # [bt, 1] each
    lane = jax.lax.broadcasted_iota(jnp.int32, (bt, nt), 1)

    def tile(jt, carry):
        b1, i1, b2, p1 = carry
        off = pl.multiple_of(jt * nt, nt)
        peqs = [peq_ref[c, pl.ds(off, nt)][None, :] for c in range(4)]
        state = _myers_init(m, (bt, nt))
        for t, wc in enumerate(wcs):          # the window, unrolled
            state = _myers_step(state, wc, peqs, jnp.int32(t), m,
                                track_pos)
        best, bestpos = state[3], state[4]
        gidx = lane + off
        ed = jnp.where(gidx < nvalid, best, BIG)
        tb1, ti1, tb2, tp1 = _top2(ed, gidx, bestpos, track_pos)
        # tiles run in ascending barcode order: a tie keeps the earlier
        # (lower-index) best, matching the reference's first argmin
        take = tb1 < b1
        return (jnp.minimum(b1, tb1), jnp.where(take, ti1, i1),
                jnp.minimum(jnp.maximum(b1, tb1), jnp.minimum(b2, tb2)),
                jnp.where(take, tp1, p1))

    big = jnp.full((bt,), BIG, jnp.int32)
    b1, i1, b2, p1 = jax.lax.fori_loop(
        0, n_tiles, tile, (big, big, big, jnp.full((bt,), -1, jnp.int32)))
    out_ref[0, :] = b1
    out_ref[1, :] = i1
    out_ref[2, :] = b2
    out_ref[3, :] = p1


@functools.partial(jax.jit, static_argnames=(
    "m", "track_pos", "bt", "nt", "num_warps"))
def sweep_top2_triton(windows_tm: jax.Array, peq: jax.Array,
                      nvalid: jax.Array, m: int, track_pos: bool = False,
                      bt: int = BT, nt: int = NT, num_warps: int = NUM_WARPS):
    """Pallas/Triton sweep; same contract as `sweep_top2_ref`. B is padded
    to the read tile and N to the barcode tile here (padded barcodes sit
    beyond nvalid and are masked; padded reads are sliced off)."""
    W, B = windows_tm.shape
    N = peq.shape[1]
    Wp = max(8, 1 << (W - 1).bit_length())   # Triton blocks are powers of 2
    Bp, Np = _round_up(B, bt), _round_up(N, nt)
    wins = jnp.pad(windows_tm.astype(jnp.int32), ((0, Wp - W), (0, Bp - B)),
                   constant_values=5)
    peq_p = jnp.pad(peq, ((0, 0), (0, Np - N)))
    kernel = functools.partial(_sweep_kernel, m=m, W=W, nt=nt,
                               n_tiles=Np // nt, track_pos=track_pos)
    out = pl.pallas_call(
        kernel,
        grid=(Bp // bt,),
        in_specs=[pl.BlockSpec((1,), lambda i: (0,)),
                  pl.BlockSpec((Wp, bt), lambda i: (0, i)),
                  pl.BlockSpec((4, Np), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((4, bt), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((4, Bp), jnp.int32),
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        backend="triton",
        name="bc_sweep_top2",
    )(nvalid.astype(jnp.int32), wins, peq_p)
    return out[:, :B]


def sweep_top2(windows_tm: jax.Array, peq: jax.Array, nvalid: jax.Array,
               m: int, track_pos: bool = False):
    """The whitelist sweep as the pipeline calls it: the Triton kernel
    when lowering for CUDA, the plain version on every other backend."""
    return jax.lax.platform_dependent(
        windows_tm, peq, nvalid,
        cuda=functools.partial(sweep_top2_triton, m=m, track_pos=track_pos),
        default=functools.partial(sweep_top2_ref, m=m, track_pos=track_pos))


# ---------------------------------------------------------------------------
# q-gram prefilter search (large used lists)
# ---------------------------------------------------------------------------
#
# The brute sweep costs O(B * N * W) integer work. For large N the candidate
# generation can go to the matrix unit instead: by the q-gram lemma
# (Ukkonen), ED(pattern, s) <= k implies pattern and s share at least
# (m - q + 1) - q*k  q-grams (bag semantics). With q = 4 the 256-dim 4-gram
# count vectors of the read window and of every barcode turn "shared >= T"
# into one [B, 256] x [256, N] matmul: dot(counts_w, counts_b) >= bag
# intersection, so dot < T proves ED > k (no false negatives; false
# positives are verified). Only the top-K scoring candidates per read then
# run the exact Myers verify — the same semantics as the
# reference's ED-neighborhood enumeration with bailout radius
# (jar BCnucTwoBitPerBaseEDtester, bailoutIfFoundAfterED): results are
# exact within `radius`, and ed/ed2 beyond the radius report as not-found.
QGRAM_Q = 4


def build_qgram_table(patterns: np.ndarray) -> np.ndarray:
    """[N, m] int8 barcode codes (all < 4) -> [256, N] float32 4-gram
    counts, the matrix operand of the prefilter product."""
    N, m = patterns.shape
    ng = m - QGRAM_Q + 1
    out = np.zeros((256, N), np.float32)
    ids = np.zeros((N, ng), np.int32)
    for i in range(QGRAM_Q):
        ids = (ids << 2) | np.minimum(patterns[:, i:ng + i], 3).astype(np.int32)
    cols = np.broadcast_to(np.arange(N)[:, None], ids.shape)
    np.add.at(out, (ids.ravel(), cols.ravel()), 1.0)
    return out


def qgram_threshold(m: int, radius: int) -> int:
    """Minimal shared-4-gram count compatible with ED <= radius."""
    return (m - QGRAM_Q + 1) - QGRAM_Q * radius


@functools.partial(jax.jit, static_argnames=("m", "radius", "K"))
def qgram_prefilter_search(windows: jax.Array, qgram_t: jax.Array,
                           peq: jax.Array, nvalid: jax.Array, m: int,
                           radius: int, K: int = 64):
    """Candidate-pruned barcode search, exact within `radius`.

    windows [B, W] int8; qgram_t [256, N] float32 (build_qgram_table);
    peq [4, N] uint32; nvalid [1] int32.
    Returns out [5, B] int32 (best_ed, best_idx, second_ed, best_end_pos,
    overflow): best/second are BIG when no barcode lies within `radius`;
    ties pick the lowest whitelist index (matching the brute sweep).
    overflow[b] = 1 when more than K candidates passed the q-gram
    threshold — caller must re-run those reads through the exact sweep.
    """
    B, W = windows.shape
    N = qgram_t.shape[1]
    T = float(qgram_threshold(m, radius))
    w = windows.astype(jnp.int32)
    ng = W - QGRAM_Q + 1
    ids = jnp.zeros((B, ng), jnp.int32)
    ok = jnp.ones((B, ng), bool)
    for i in range(QGRAM_Q):
        c = w[:, i:ng + i]
        ok &= c < 4
        ids = (ids << 2) | jnp.minimum(c, 3)
    onehot = (ids[:, :, None] == jnp.arange(256, dtype=jnp.int32)[None, None, :])
    counts = jnp.sum(jnp.where(ok[:, :, None], onehot, False),
                     axis=1).astype(jnp.bfloat16)
    # The product is exact: both operands are small integer 4-gram counts
    # (at most W - 3 = 19 per window, 13 per barcode), exactly
    # representable in bf16, and every partial sum stays far below 2^24
    # in the float32 accumulator — so no TF32 or bf16 rounding can arise.
    scores = jnp.dot(counts, qgram_t.astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)  # [B, N]
    lane = jnp.arange(N, dtype=jnp.int32)[None, :] < nvalid[0]
    scores = jnp.where(lane, scores, -1.0)
    overflow = (jnp.sum(scores >= T, axis=1) > K).astype(jnp.int32)
    top_s, top_i = jax.lax.top_k(scores, K)          # [B, K]
    cand_ok = top_s >= T

    # exact Myers verify on the K candidates (per-read pattern set)
    peq_c = jnp.stack([peq[c][top_i] for c in range(4)], axis=0)  # [4, B, K]
    hibit = jnp.uint32(m - 1)
    full = _full_mask(m)

    def step(carry, inp):
        PV, MV, score, best, best_pos = carry
        wc, t = inp
        z = jnp.uint32(0)
        eq = jnp.where((wc == 0)[:, None], peq_c[0],
              jnp.where((wc == 1)[:, None], peq_c[1],
               jnp.where((wc == 2)[:, None], peq_c[2],
                jnp.where((wc == 3)[:, None], peq_c[3], z))))
        PV, MV, score = editdist._hyyro_step(PV, MV, score, eq, hibit, 0)
        improved = score < best
        best = jnp.where(improved, score, best)
        best_pos = jnp.where(improved, t, best_pos)
        return (PV, MV, score, best, best_pos), None

    PV0 = jnp.full((B, K), full, jnp.uint32)
    MV0 = jnp.zeros((B, K), jnp.uint32)
    s0 = jnp.full((B, K), m, jnp.int32)
    bp0 = jnp.full((B, K), -1, jnp.int32)
    (_, _, _, ed, pos), _ = jax.lax.scan(
        step, (PV0, MV0, s0, s0, bp0),
        (windows.T.astype(jnp.int8), jnp.arange(W, dtype=jnp.int32)))

    inrad = cand_ok & (ed <= radius)
    ed = jnp.where(inrad, ed, BIG)
    gidx = jnp.where(inrad, top_i, BIG)
    b1 = jnp.min(ed, axis=1)
    i1 = jnp.min(jnp.where(ed == b1[:, None], gidx, BIG), axis=1)
    b2 = jnp.min(jnp.where(gidx == i1[:, None], BIG, ed), axis=1)
    p1 = jnp.max(jnp.where(gidx == i1[:, None], pos, -1), axis=1)
    return jnp.stack([b1, jnp.minimum(i1, BIG), b2, p1, overflow], axis=0)


def bc_search(windows: np.ndarray, patterns_peq: np.ndarray, n_patterns: int,
              m: int):
    """Host wrapper around `sweep_top2` (pads the batch to a power-of-two
    bucket to bound the compiled shapes).

    Args:
      windows: [B, W] int8 base codes (the BC search window per read).
      patterns_peq: [4, N] uint32 from editdist.build_peq (N may be unpadded).
      n_patterns: number of valid patterns (<= N).
      m: pattern length.
    Returns:
      dict of numpy arrays (len B): ed, idx, ed2, end_pos.
      idx/end_pos are valid only where ed < m; ed2 == editdist.INT_MAX when
      no second candidate exists (mirrors the reference's ed_sec=INTMAX).
    """
    B, W = windows.shape
    Bp = 8
    while Bp < B:
        Bp *= 2
    wins = np.full((W, Bp), 5, dtype=np.int32)  # PAD
    wins[:, :B] = np.asarray(windows).T
    out = np.asarray(sweep_top2(
        jnp.asarray(wins), jnp.asarray(patterns_peq[:, :max(n_patterns, 1)]),
        jnp.asarray([n_patterns], dtype=jnp.int32), m, track_pos=True))
    ed, idx, ed2, pos = out[0, :B], out[1, :B], out[2, :B], out[3, :B]
    ed2 = np.where(ed2 >= int(BIG), editdist.INT_MAX, ed2).astype(np.int64)
    return {"ed": np.asarray(ed, dtype=np.int64),
            "idx": np.asarray(idx, dtype=np.int64),
            "ed2": ed2,
            "end_pos": np.asarray(pos, dtype=np.int64)}
