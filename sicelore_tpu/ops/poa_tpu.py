"""Batched device consensus engine (the spoa replacement's device path).

The reference forks one `spoa` process per molecule (~167 UMIs/s on 20
cores, SURVEY.md). Here consensus is a fixed-shape batched computation:

  * per molecule: center = longest cDNA; every other read forms a
    (center, read) pair
  * each pair aligns with banded Needleman-Wunsch (match +5 / mismatch -4
    / gap -8 — spoa defaults) over a width-32 or -64 diagonal band; the
    forward keeps two traceback bits per band cell and a deterministic
    greedy traceback (diag > vert > horiz) emits one packed walk record
    per center column (`band_records`: Triton kernels on the GPU, the
    plain jnp version elsewhere)
  * aligned/insertion codes are recovered from the records by static
    sliding slices; votes segment-sum per molecule on device; consensus
    assembly (majority + agreement QV + gap stripping, ConsensusMsa
    semantics — utils/ConsensusMsa.java:51-91) also runs on device, and
    only the compacted consensus (1 byte/column: qv<<2 | base) is
    downloaded
  * host decodes strings; 1/2-read molecules short-circuit like the
    reference (Consensus.java:201-206)

Shapes are bucketed (Lc to powers of two, band W static, pair count to a
1.5x/2x grid) so a handful of executables serve any workload. The jnp
formulation `consensus_votes` + host `_assemble` is the oracle the device
route is asserted byte-equal to (tests/test_poa_tpu.py).
"""
from __future__ import annotations

import functools
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from sicelore_tpu.ops import poa
from sicelore_tpu.utils import dna

MATCH, MISMATCH, GAP = poa.MATCH, poa.MISMATCH, poa.GAP
NEG = -(10**7)
K_INS = 4
_ACGT = b"ACGTacgt"  # delete-set for the N/ambiguity screen


# ---------------------------------------------------------------------------
# jnp oracle engine (test reference of the device route)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("W", "M"))
def consensus_votes(center: jax.Array, clens: jax.Array, reads: jax.Array,
                    rlens: jax.Array, mol_ids: jax.Array, W: int, M: int):
    """Votes for one bucket (jnp oracle; `band_align` + `votes_assemble`
    is the production route).

    center [P, Lc] int8 codes, clens [P] int32, reads [P, Lr] int8,
    rlens [P] int32, mol_ids [P] int32 (segment ids < M).
    Returns (col_votes [M, Lc+1, 5] int32 — channels A,C,G,T,gap —
    ins_votes [M, Lc+1, K_INS, 4] int32, pair_counts [M] int32).
    Insertion column j = insertions between center pos j-1 and j
    (j=0: before the first base).
    """
    P, Lc = center.shape
    Lr = reads.shape[1]
    W2 = W // 2
    bidx = jnp.arange(W, dtype=jnp.int32)[None, :]          # [1, W]
    g = jnp.int32(GAP)

    def sub_col(j):
        """Substitution scores for column j (1-based): center[j-1] vs
        read[i-1], i = j + b - W2. [P, W]."""
        i = j + bidx - W2                                    # [P->1, W]
        cb = center[:, j - 1][:, None]
        rb = jnp.take_along_axis(
            reads, jnp.clip(i - 1, 0, Lr - 1), axis=1)
        s = jnp.where((cb == rb) & (cb < 4), MATCH, MISMATCH)
        valid = (i >= 1) & (i <= rlens[:, None])
        return jnp.where(valid, s, NEG).astype(jnp.int32)

    def colmax_left(f):
        """Within-column center-gap closure: f[b] = max_k<=b f[k]+(b-k)G."""
        t = f - bidx * g
        t = jax.lax.associative_scan(jnp.maximum, t, axis=1)
        return jnp.maximum(f, t + bidx * g)

    # ---- forward ----
    i0 = bidx - W2
    F0 = jnp.where((i0 >= 0) & (i0 <= rlens[:, None]), i0 * g, NEG)

    def fstep(Fprev, j):
        s = sub_col(j)
        diag = Fprev + s
        up = jnp.concatenate([Fprev[:, 1:], jnp.full((P, 1), NEG,
                                                     jnp.int32)], axis=1) + g
        f = jnp.maximum(diag, up)
        f = colmax_left(f)
        f = jnp.maximum(f, NEG)
        # columns beyond this pair's center length keep previous state
        f = jnp.where(j <= clens[:, None], f, Fprev)
        return f, f.astype(jnp.int32)

    _, Fstack = jax.lax.scan(fstep, F0,
                             jnp.arange(1, Lc + 1, dtype=jnp.int32))
    F = jnp.concatenate([F0[:, None, :], jnp.swapaxes(Fstack, 0, 1)],
                        axis=1)  # [P, Lc+1, W]

    # ---- deterministic batched traceback (greedy: diag > vert > horiz) ----
    # One canonical optimal path per pair. An F+B on-path mask instead marks
    # ALL co-optimal cells, and indels floating in homopolymers then vote
    # phantom insertions at several columns — measured +2.7% consensus
    # length inflation. Sequential over path steps, vectorized over pairs.
    bt = rlens - clens + W2
    total = jnp.take_along_axis(
        jnp.take_along_axis(F, clens[:, None, None], axis=1)[:, 0, :],
        jnp.clip(bt, 0, W - 1)[:, None], axis=1)[:, 0]
    feasible = (bt >= 0) & (bt < W) & (total > NEG // 2)

    Fflat = F.reshape(P, (Lc + 1) * W)
    pidx = jnp.arange(P)

    def gatherF(j, b):
        idx = jnp.clip(j, 0, Lc) * W + jnp.clip(b, 0, W - 1)
        return jnp.take_along_axis(Fflat, idx[:, None], axis=1)[:, 0]

    S = Lc + W + 8  # path length <= clens + #insertions (<= band width)
    votes0 = jnp.zeros((P, Lc + 1, 5), jnp.int32)
    ins0 = jnp.zeros((P, Lc + 1, K_INS, 4), jnp.int32)

    def tstep(carry, _):
        j, b, run, votes, ins = carry
        i = j + b - W2
        active = feasible & ((j > 0) | (b > W2))
        F_cur = gatherF(j, b)
        cb = jnp.take_along_axis(
            center, jnp.clip(j - 1, 0, Lc - 1)[:, None], axis=1)[:, 0]
        rb = jnp.take_along_axis(
            reads, jnp.clip(i - 1, 0, Lr - 1)[:, None], axis=1)[:, 0]
        sub = jnp.where((cb == rb) & (cb < 4), MATCH, MISMATCH)
        diag = active & (j > 0) & (i >= 1) & (F_cur == gatherF(j - 1, b) + sub)
        vert = (active & ~diag & (j > 0) & (b + 1 < W)
                & (F_cur == gatherF(j - 1, b + 1) + g))
        horiz = active & ~diag & ~vert & (b > 0)
        colc = jnp.clip(j - 1, 0, Lc)
        chan = jnp.where(diag, jnp.clip(rb, 0, 3).astype(jnp.int32), 4)
        votes = votes.at[pidx, colc, chan].add((diag | vert).astype(jnp.int32))
        # horiz consumes read char i (insertion before center pos j);
        # offsets count from the run END (right-justified across reads,
        # consistently — the trace walks the run backward)
        o = jnp.minimum(run, K_INS - 1)
        ins = ins.at[pidx, jnp.clip(j, 0, Lc), o,
                     jnp.clip(rb, 0, 3).astype(jnp.int32)].add(
            horiz.astype(jnp.int32))
        dj = (diag | vert).astype(jnp.int32)
        j2 = j - dj
        b2 = b + vert.astype(jnp.int32) - horiz.astype(jnp.int32)
        run2 = jnp.where(horiz, run + 1, 0)
        return (j2, b2, run2, votes, ins), None

    j0 = clens
    b0 = jnp.clip(bt, 0, W - 1)
    run0 = jnp.zeros((P,), jnp.int32)
    (jf, bf, _, votesP, insP), _ = jax.lax.scan(
        tstep, (j0, b0, run0, votes0, ins0), None, length=S)

    col_votes = jax.ops.segment_sum(votesP, mol_ids, num_segments=M)
    ins_votes = jax.ops.segment_sum(insP, mol_ids, num_segments=M)
    pair_counts = jax.ops.segment_sum(
        feasible.astype(jnp.int32), mol_ids, num_segments=M)
    return col_votes, ins_votes, pair_counts


# ---------------------------------------------------------------------------
# Band alignment: forward DP -> traceback walk records
# ---------------------------------------------------------------------------
#
# Contract shared by the plain version (`band_records_ref`) and the Triton
# kernels (`band_records_triton`): per pair, a banded NW forward over the
# center columns j = 1..Lc keeps only TWO BITS per band cell — "diag move
# reproduces F here" and "vert move reproduces F here", the two tests of
# the greedy traceback (diag > vert > horiz) — packed 32 bands per uint32
# word. The traceback then walks the bit words from (clen, bt) back to
# column 0 and emits ONE packed record per (pair, center column):
#
#   bstop | be<<6 | diag<<12 | vert<<13 | active<<14
#
# (be = band on entry to the column, bstop = band where the column's
# horizontal run stops), plus a drain record for the read prefix before
# the first center base. The F matrix itself never leaves the forward loop.
#
# Feasibility ("can (clen, bt) be reached inside the band without consuming
# read chars beyond rlen?") is the jnp oracle's score threshold: any
# invalid step costs NEG, unrecoverable, while every fully-valid path
# scores > -8*(Lc+W) > NEG//2.

PAIR_STEP = 32  # pairs per kernel program; pair batches pad to a multiple


def w_for(Lc: int) -> int:
    """Band width per center-length bucket: alignment drift grows ~sqrt(L)
    (random indel imbalance), so short molecules ride the cheap 32-band
    and longer ones the 64-band — at 5% read error a +-16 band was
    measured to corrupt ~5% of ~1 kb consensuses while +-32 matches the
    host engine, and at 8% error the +-16 band already misses the
    accuracy bound of tests/test_poa_tpu.py on 500 nt molecules."""
    return 32 if Lc <= 256 else 64


def padl_for(W: int) -> int:
    """Top PAD of the read rows: read char i (1-based) sits at padded row
    i + W//2, so cell (column j, band b) reads row j + b."""
    return W // 2 + 1


def _pack_bits(m, W: int):
    """bool [P, W] -> uint32 [P, W // 32] (band b -> bit b % 32 of word
    b // 32)."""
    P = m.shape[0]
    sh = jnp.arange(32, dtype=jnp.uint32)
    w = m.reshape(P, W // 32, 32).astype(jnp.uint32) << sh
    return jnp.sum(w, axis=2, dtype=jnp.uint32)


def _traceback_col(b, frozen, active_col, dws, vws):
    """One traceback column for a vector of pairs. dws/vws: per 32-band
    word k the diag/vert bit words [P] uint32. Returns (record, b', frozen')
    — the same arithmetic in the plain scan and the Triton kernel."""
    bstop = jnp.zeros_like(b)
    sdiag = jnp.zeros_like(b)
    svert = jnp.zeros_like(b)
    for k, (dw, vw) in enumerate(zip(dws, vws)):
        rel = b - 32 * k
        low = jnp.where(rel >= 31, jnp.uint32(0xFFFFFFFF),
                        (jnp.uint32(2) << jnp.clip(rel, 0, 30).astype(
                            jnp.uint32)) - jnp.uint32(1))
        low = jnp.where(rel < 0, jnp.uint32(0), low)
        ok = (dw | vw | (jnp.uint32(1) if k == 0 else jnp.uint32(0))) & low
        top = 31 - jax.lax.clz(ok.astype(jnp.int32))
        hit = ok != 0
        sh = jnp.clip(top, 0, 31).astype(jnp.uint32)
        bstop = jnp.where(hit, top + 32 * k, bstop)
        sdiag = jnp.where(hit, ((dw >> sh) & 1).astype(jnp.int32), sdiag)
        svert = jnp.where(hit, ((vw >> sh) & 1).astype(jnp.int32), svert)
    stuck = (1 - sdiag) * (1 - svert)
    active = active_col * (1 - frozen)
    rec = (bstop | (b << 6) | ((sdiag * active) << 12)
           | ((svert * active) << 13) | (active << 14))
    frozen = jnp.maximum(frozen, active * stuck)
    move = active * (1 - stuck)
    b = b * (1 - move) + (bstop + svert) * move
    return rec, b, frozen


def _drain(b, frozen, feasible, W: int):
    """j = 0 record: remaining insertions (read prefix before the center
    start; the walk stops at band W/2 — read position 0)."""
    W2 = W // 2
    active0 = feasible * (1 - frozen) * (b > W2).astype(jnp.int32)
    return jnp.minimum(b, W2) | (b << 6) | (active0 << 14)


@functools.partial(jax.jit, static_argnames=("W",))
def band_records_ref(cent_tm, reads_v, clens, rlens, W: int):
    """Plain jnp band alignment.

    cent_tm [Lc, P] i8 center codes (text-major); reads_v [Lrp, P] i8 read
    codes at padded rows (row r holds read char i = r - W//2), 4 outside
    [1, rlen]; clens/rlens [P] i32. Returns (records [P, Lc+1] i32 —
    slot t < Lc describes column j = t+1, slot Lc the j = 0 drain —
    feasible [P] i32)."""
    Lc, P = cent_tm.shape
    W2 = W // 2
    g = jnp.int32(GAP)
    neg = jnp.int32(NEG)
    band = jnp.arange(W, dtype=jnp.int32)[None, :]
    i0 = band - W2
    F0 = jnp.where((i0 >= 0) & (i0 <= rlens[:, None]), i0 * g, neg)

    def colmax_left(f):
        t = jax.lax.associative_scan(jnp.maximum, f - band * g, axis=1)
        return jnp.maximum(f, t + band * g)

    def fstep(f, j):
        cc = jax.lax.dynamic_index_in_dim(cent_tm, j - 1, 0, keepdims=False)
        rc = jnp.transpose(jax.lax.dynamic_slice_in_dim(reads_v, j, W, 0))
        valid = rc < 4
        sc = jnp.where(rc == cc[:, None], MATCH,
                       jnp.where(valid, MISMATCH, neg))
        up = jnp.concatenate([f[:, 1:], jnp.full((P, 1), neg)], axis=1) + g
        fn = jnp.maximum(colmax_left(jnp.maximum(f + sc, up)), neg)
        fn = jnp.where(j <= clens[:, None], fn, f)
        dm = valid & (fn == f + sc)
        vm = ~dm & (band + 1 < W) & (fn == up)
        return fn, (_pack_bits(dm, W), _pack_bits(vm, W))

    cols = jnp.arange(1, Lc + 1, dtype=jnp.int32)
    fL, (D, V) = jax.lax.scan(fstep, F0, cols)           # D, V [Lc, P, nw]
    bt = rlens - clens + W2
    btc = jnp.clip(bt, 0, W - 1)
    total = jnp.take_along_axis(fL, btc[:, None], axis=1)[:, 0]
    feasible = ((bt >= 0) & (bt < W) & (total > NEG // 2)).astype(jnp.int32)

    def tstep(carry, x):
        b, frozen = carry
        j, dw, vw = x
        act = feasible * (j <= clens).astype(jnp.int32)
        rec, b, frozen = _traceback_col(
            b, frozen, act, [dw[:, k] for k in range(W // 32)],
            [vw[:, k] for k in range(W // 32)])
        return (b, frozen), rec

    (b, frozen), recs = jax.lax.scan(
        tstep, (btc, jnp.zeros_like(btc)), (cols, D, V), reverse=True)
    drain = _drain(b, frozen, feasible, W)
    return (jnp.concatenate([jnp.transpose(recs), drain[:, None]], axis=1),
            feasible)


def unpack2bit_cols(packed: jax.Array) -> jax.Array:
    """[E, P] u8 (4 bases/byte along rows) -> [4E, P] i8 codes."""
    E, P = packed.shape
    parts = [((packed >> s) & jnp.uint8(3)).astype(jnp.int8)
             for s in (0, 2, 4, 6)]
    return jnp.stack(parts, axis=1).reshape(E * 4, P)


def unpack2bit_rows(packed: jax.Array) -> jax.Array:
    """[M, E] u8 (4 bases/byte along columns) -> [M, 4E] i8 codes."""
    M, E = packed.shape
    parts = [((packed >> s) & jnp.uint8(3)).astype(jnp.int8)
             for s in (0, 2, 4, 6)]
    return jnp.stack(parts, axis=2).reshape(M, E * 4)


def pack2bit_cols_np(codes: np.ndarray) -> np.ndarray:
    """[4E, P] int8 codes -> [E, P] u8 (codes > 3 clip to 3: device pads
    are masked by lens, and N-containing molecules never reach here)."""
    c = np.minimum(codes, 3).astype(np.uint8)
    return c[0::4] | (c[1::4] << 2) | (c[2::4] << 4) | (c[3::4] << 6)


def pack2bit_rows_np(codes: np.ndarray) -> np.ndarray:
    """[M, 4E] int8 codes -> [M, E] u8."""
    c = np.minimum(codes, 3).astype(np.uint8)
    return (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
            | (c[:, 3::4] << 6))


def _band_fwd_kernel(cent_ref, reads_ref, clen_ref, rlen_ref, d_ref, v_ref,
                     feas_ref, *, Lc: int, W: int):
    """Forward DP for one block of pairs, ONE PAIR PER THREAD: the W band
    cells are W registers per thread, so the within-column shifts are
    register renames and the center-gap closure is a chain of W maxes —
    no cross-thread traffic. Per column only the diag/vert bit words are
    stored (text-major [Lc, W//32, pairs], coalesced)."""
    W2 = W // 2
    g = jnp.int32(GAP)
    neg = jnp.int32(NEG)
    clen = clen_ref[...]
    rlen = rlen_ref[...]
    zero = jnp.zeros_like(clen)
    f0 = [jnp.where((b - W2 >= 0) & (b - W2 <= rlen), (b - W2) * g, neg)
          for b in range(W)]
    rc0 = [reads_ref[1 + b, :].astype(jnp.int32) for b in range(W)]

    def col(j, carry):
        f, rcw = carry
        cc = cent_ref[j - 1, :].astype(jnp.int32)
        inr = j <= clen
        sc = [jnp.where(r == cc, MATCH, jnp.where(r < 4, MISMATCH, neg))
              for r in rcw]
        up = [(f[b + 1] if b + 1 < W else zero + neg) + g for b in range(W)]
        fn, c = [], None
        for b in range(W):
            x = jnp.maximum(f[b] + sc[b], up[b])
            c = x if c is None else jnp.maximum(x, c + g)
            fn.append(jnp.where(inr, jnp.maximum(c, neg), f[b]))
        for k in range(W // 32):
            dw = jnp.zeros(clen.shape, jnp.uint32)
            vw = jnp.zeros(clen.shape, jnp.uint32)
            for b in range(32 * k, 32 * k + 32):
                dm = (rcw[b] < 4) & (fn[b] == f[b] + sc[b])
                vm = ~dm & (fn[b] == up[b]) if b + 1 < W else dm & ~dm
                dw = dw | (dm.astype(jnp.uint32) << (b % 32))
                vw = vw | (vm.astype(jnp.uint32) << (b % 32))
            d_ref[j - 1, k, :] = dw
            v_ref[j - 1, k, :] = vw
        nxt = reads_ref[j + W, :].astype(jnp.int32)
        return fn, rcw[1:] + [nxt]

    f, _ = jax.lax.fori_loop(1, Lc + 1, col, (f0, rc0))
    bt = rlen - clen + W2
    total = zero + neg
    for b in range(W):
        total = jnp.where(bt == b, f[b], total)
    feas_ref[...] = ((bt >= 0) & (bt < W)
                     & (total > NEG // 2)).astype(jnp.int32)


def _band_tb_kernel(d_ref, v_ref, clen_ref, rlen_ref, feas_ref, rec_ref,
                    drain_ref, *, Lc: int, W: int):
    """Greedy traceback for one block of pairs over the stored bit words,
    one pair per thread; emits the walk records text-major."""
    clen = clen_ref[...]
    feasible = feas_ref[...]
    bt = rlen_ref[...] - clen + W // 2
    b0 = jnp.clip(bt, 0, W - 1)

    def col(jr, carry):
        b, frozen = carry
        j = Lc - jr
        act = feasible * (j <= clen).astype(jnp.int32)
        rec, b, frozen = _traceback_col(
            b, frozen, act, [d_ref[j - 1, k, :] for k in range(W // 32)],
            [v_ref[j - 1, k, :] for k in range(W // 32)])
        rec_ref[j - 1, :] = rec
        return b, frozen

    b, frozen = jax.lax.fori_loop(0, Lc, col, (b0, jnp.zeros_like(b0)))
    drain_ref[...] = _drain(b, frozen, feasible, W)


@functools.partial(jax.jit, static_argnames=("W",))
def band_records_triton(cent_tm, reads_v, clens, rlens, W: int):
    """Pallas/Triton band alignment; same contract as `band_records_ref`.
    Two kernels: the forward writes 2 bits per band cell, the traceback
    reads them back (L2-resident at the bench's bucket sizes)."""
    Lc, P = cent_tm.shape
    Lrp = reads_v.shape[0]
    nw = W // 32
    PB = PAIR_STEP
    Pp = (P + PB - 1) // PB * PB
    if Pp != P:
        pad = ((0, 0), (0, Pp - P))
        cent_tm = jnp.pad(cent_tm, pad)
        reads_v = jnp.pad(reads_v, pad, constant_values=4)
        clens = jnp.pad(clens, (0, Pp - P))
        rlens = jnp.pad(rlens, (0, Pp - P))
    grid = (Pp // PB,)
    vec = pl.BlockSpec((PB,), lambda i: (i,))
    bits = pl.BlockSpec((Lc, nw, PB), lambda i: (0, 0, i))
    params = pltriton.CompilerParams(num_warps=PB // 32, num_stages=1)
    D, V, feas = pl.pallas_call(
        functools.partial(_band_fwd_kernel, Lc=Lc, W=W),
        grid=grid,
        in_specs=[pl.BlockSpec((Lc, PB), lambda i: (0, i)),
                  pl.BlockSpec((Lrp, PB), lambda i: (0, i)), vec, vec],
        out_specs=[bits, bits, vec],
        out_shape=[jax.ShapeDtypeStruct((Lc, nw, Pp), jnp.uint32),
                   jax.ShapeDtypeStruct((Lc, nw, Pp), jnp.uint32),
                   jax.ShapeDtypeStruct((Pp,), jnp.int32)],
        compiler_params=params, backend="triton", name="band_align_fwd",
    )(cent_tm, reads_v, clens, rlens)
    recs, drain = pl.pallas_call(
        functools.partial(_band_tb_kernel, Lc=Lc, W=W),
        grid=grid,
        in_specs=[bits, bits, vec, vec, vec],
        out_specs=[pl.BlockSpec((Lc, PB), lambda i: (0, i)), vec],
        out_shape=[jax.ShapeDtypeStruct((Lc, Pp), jnp.int32),
                   jax.ShapeDtypeStruct((Pp,), jnp.int32)],
        compiler_params=params, backend="triton",
        name="band_align_traceback",
    )(D, V, clens, rlens, feas)
    tb = jnp.concatenate([jnp.transpose(recs), drain[:, None]], axis=1)
    return tb[:P], feas[:P]


def band_records(cent_tm, reads_v, clens, rlens, W: int):
    """Walk records of every pair: the Triton kernels when lowering for
    CUDA, the plain version on every other backend (same contract as
    `band_records_ref`)."""
    return jax.lax.platform_dependent(
        cent_tm, reads_v, clens, rlens,
        cuda=functools.partial(band_records_triton, W=W),
        default=functools.partial(band_records_ref, W=W))


@functools.partial(jax.jit, static_argnames=("Lc",))
def band_align(reads2b: jax.Array, rlens: jax.Array, mids: jax.Array,
               cmol2b: jax.Array, clm: jax.Array, Lc: int):
    """Align P (center, read) pairs from the 2-bit DEDUPLICATED uploads.

    reads2b [Lrp//4, P] u8 — pair p's read 2-bit packed text-major,
    starting at unpacked row padl_for(W) (Lrp >= padl_for(W) + Lc + W);
    rlens [P] i32; mids [P] i32 molecule ids < M2; cmol2b [M2, Lc//4] u8
    2-bit packed per-MOLECULE centers; clm [M2] i32. Each pair's center is
    gathered on device from its molecule row.
    Returns (aligned [P, Lc+1] i8 — 0..3 read base on diag / 4 deletion /
    5 none — ins_votes [P, Lc+1, K_INS, 4] i8 with row j = insertions
    before center pos j, feasible [P] i32, cmol [M2, Lc] i8 unpacked)."""
    W = w_for(Lc)
    reads_tm = unpack2bit_cols(reads2b)                  # [Lrp, P] i8
    cmol = unpack2bit_rows(cmol2b)                       # [M2, Lc] i8
    cent_tm = jnp.transpose(jnp.take(cmol, mids, axis=0))  # [Lc, P] i8
    clens = jnp.take(clm, mids)
    # read index of each padded row; cells outside [1, rlen] score NEG
    i_row = jnp.arange(reads_tm.shape[0], dtype=jnp.int32)[:, None] - W // 2
    reads_v = jnp.where((i_row >= 1) & (i_row <= rlens[None, :]), reads_tm,
                        jnp.int8(4))
    tb, feasible = band_records(cent_tm, reads_v, clens, rlens, W)
    aligned, ins_votes = extract_alignments(tb, jnp.transpose(reads_tm),
                                            Lc, W)
    return aligned, ins_votes, feasible, cmol


@functools.partial(jax.jit, static_argnames=("Lc", "W"))
def extract_alignments(tb: jax.Array, reads_p: jax.Array, Lc: int, W: int):
    """Unpack the walk records into aligned codes + insertion votes — no
    gathers: read chars resolve through one sliding slice of the reads
    per band lane.

    tb [P, Lc+1] i32 packed bstop | be<<6 | diag<<12 | vert<<13 |
    active<<14; slot t < Lc records column j = t+1, slot Lc the j = 0
    insertion drain; reads_p [P, Lrp] i8 padded read codes. Returns
    (aligned [P, Lc+1] i8, ins_votes [P, Lc+1, K_INS, 4] i8 with row j =
    insertions before center pos j). A horizontal run longer than K_INS
    piles every excess char's vote into the last offset slot, exactly like
    the jnp oracle's `o = min(run, K_INS-1)` accumulation."""
    P, Lc1 = tb.shape
    bstop = tb & 63
    be = (tb >> 6) & 63
    diag = (tb >> 12) & 1
    vert = (tb >> 13) & 1
    active = (tb >> 14) & 1
    slot = jnp.arange(Lc1, dtype=jnp.int32)[None, :]

    # insertion votes: the run consumed read chars at band lanes
    # (bstop, be], read index j + lane; offset o counts from the run END
    # (right-justified trace order), o >= K_INS-1 piles into the last slot.
    # The diag move of slot t reads the char at band bstop. One rolled loop
    # over the band lanes: a Python-unrolled lane loop compiles W*4*K_INS
    # separate ops (tens of seconds of XLA compile per bucket shape).
    K = K_INS
    am = active > 0
    offs = jnp.arange(K - 1, dtype=jnp.int32)[:, None, None]
    chans = jnp.arange(4, dtype=jnp.int8)[:, None, None]

    def lane(b, carry):
        ch, acc = carry
        # main slots t < Lc read index (t+1)+b; drain slot index b
        rc = jnp.concatenate(
            [jax.lax.dynamic_slice_in_dim(reads_p, 1 + b, Lc, axis=1),
             jax.lax.dynamic_slice_in_dim(reads_p, b, 1, axis=1)], axis=1)
        ch = jnp.where(bstop == b, rc.astype(jnp.int32), ch)
        in_run = am & (bstop < b)
        sel = jnp.concatenate([be[None] - offs == b,
                               (b <= be - (K - 1))[None]], axis=0)
        hit = (sel & in_run[None])[:, None] & (rc[None] == chans)[None]
        return ch, acc + hit.astype(jnp.int8)            # [K, 4, P, Lc+1]

    ch, acc = jax.lax.fori_loop(
        0, W, lane, (jnp.zeros((P, Lc1), jnp.int32),
                     jnp.zeros((K, 4, P, Lc1), jnp.int8)))
    emitted = jnp.where(diag > 0, ch, jnp.where(vert > 0, 4, 5))
    # slot t's record describes the move INTO column t's base slot; the
    # drain slot emits no base
    aligned = jnp.where(slot < Lc, emitted, 5).astype(jnp.int8)
    ins_by_slot = jnp.transpose(acc, (2, 3, 0, 1))       # [P, Lc+1, K, 4]
    # reorder to insertion rows: row 0 = drain (slot Lc), row j = slot j-1
    ins_votes = jnp.concatenate([ins_by_slot[:, Lc:], ins_by_slot[:, :Lc]],
                                axis=1)
    return aligned, ins_votes


@functools.partial(jax.jit, static_argnames=("M",))
def segment_votes(aligned, ins, feasible, mids, M: int):
    """Per-pair alignments -> per-molecule vote tensors (the additive,
    psum-mergeable half of the assembly — the multi-chip step psums these
    across the data axis before assemble_votes).

    aligned [P, Lc+1] int (0..3 base / 4 del / 5 none), ins
    [P, Lc+1, K_INS, 4] i8, feasible [P], mids [P] segment ids < M.
    Returns (cv [M, Lc, 5] i32, iv [M, Lc+1, K_INS, 4] i32, pc [M])."""
    Lc = aligned.shape[1] - 1
    ch5 = jnp.arange(5, dtype=jnp.int32)
    cv = jax.ops.segment_sum(
        (aligned[:, :Lc, None] == ch5).astype(jnp.int32), mids,
        num_segments=M)                                     # [M, Lc, 5]
    iv = jax.ops.segment_sum(ins.astype(jnp.int32), mids,
                             num_segments=M)                # [M, Lc+1, K, 4]
    pc = jax.ops.segment_sum(feasible.astype(jnp.int32), mids,
                             num_segments=M)
    return cv, iv, pc


@functools.partial(jax.jit, static_argnames=("maxps", "out_cols"))
def assemble_votes(cv, iv, pc, centers_mol, clen_mol, maxps: int,
                   out_cols: int):
    """Per-molecule vote tensors -> compacted consensus bytes, on device.

    cv [M, Lc, 5] i32, iv [M, Lc+1, K_INS, 4] i32, pc [M] (from
    segment_votes, possibly psum-merged across chips), centers_mol
    [M, Lc] i8, clen_mol [M] i32. Returns (packed [M, out_cols] u8 —
    qv<<2 | base — out_len [M], pair_counts [M], overflow [M] bool).
    Assembly semantics == BatchedConsensusEngine host _assemble ==
    ConsensusMsa.process (utils/ConsensusMsa.java:51-91)."""
    M, Lc = cv.shape[:2]
    Lc1 = Lc + 1
    K = K_INS
    ch5 = jnp.arange(5, dtype=jnp.int32)
    R = pc + 1                                              # center votes too
    cols = jnp.arange(Lc, dtype=jnp.int32)
    cmask = cols[None, :] < clen_mol[:, None]               # [M, Lc]
    conh = ((jnp.minimum(centers_mol.astype(jnp.int32), 4)[..., None] == ch5)
            & cmask[..., None])
    cv = cv + conh.astype(jnp.int32)

    # base slots
    bb = jnp.argmax(cv, axis=2)                             # [M, Lc]
    bw = jnp.take_along_axis(cv, bb[..., None], axis=2)[..., 0]
    keep_base = (bb != 4) & cmask
    # insertion slots: argmax base wins iff votes > gap votes (R - sum)
    ib = jnp.argmax(iv, axis=3)                             # [M, Lc+1, K]
    ivw = jnp.take_along_axis(iv, ib[..., None], axis=3)[..., 0]
    rmask = (jnp.arange(Lc1, dtype=jnp.int32)[None, :]
             <= clen_mol[:, None])                          # [M, Lc+1]
    ikeep = ((ivw > (R[:, None, None] - iv.sum(axis=3))) & (ivw > 0)
             & rmask[..., None])

    def qv_of(win, keep):
        frac = win / jnp.maximum(R, 1)[:, None].astype(jnp.float32)
        q = jnp.rint(-10.0 * jnp.log10(jnp.maximum(1.0 - frac, 1e-9)))
        q = jnp.where(frac >= 1.0, maxps, jnp.minimum(q, maxps))
        return jnp.where(keep, q, 0.0).astype(jnp.int32)

    # slot layout per center row j: K insertion slots (o = K-1..0, i.e.
    # right-justified trace order) then the base slot
    ins_code = ib[:, :, ::-1]                               # o descending
    ins_win = ivw[:, :, ::-1]
    ins_keep = ikeep[:, :, ::-1]
    base_code = jnp.concatenate(
        [bb, jnp.zeros((M, 1), bb.dtype)], axis=1)[:, :, None]  # [M, Lc+1, 1]
    base_win = jnp.concatenate(
        [bw, jnp.zeros((M, 1), bw.dtype)], axis=1)[:, :, None]
    base_keep = jnp.concatenate(
        [keep_base, jnp.zeros((M, 1), bool)], axis=1)[:, :, None]
    code = jnp.concatenate([ins_code, base_code], axis=2).reshape(M, -1)
    win = jnp.concatenate([ins_win.astype(jnp.int32),
                           base_win.astype(jnp.int32)], axis=2).reshape(M, -1)
    keep = jnp.concatenate([ins_keep, base_keep], axis=2).reshape(M, -1)

    q = qv_of(win.astype(jnp.float32), keep)
    val = ((q.astype(jnp.int32) << 2) | jnp.minimum(code, 3))
    out_idx = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1
    out_len = out_idx[:, -1] + 1
    # stream compaction WITHOUT scatter: per-row sort of (target_idx<<8 |
    # value) with dropped slots keyed past every kept one — kept slots'
    # out_idx is strictly increasing, so the sorted prefix IS the
    # compacted stream.
    S = keep.shape[1]
    pk = jnp.where(keep, (out_idx << 8) | val, (S << 8) | 0xFF)
    srt = jax.lax.sort(pk, dimension=1)[:, :out_cols]
    packed = jnp.where((srt >> 8) < S, srt & 0xFF, 0).astype(jnp.uint8)
    overflow = out_len > out_cols
    return packed, out_len, pc, overflow


@functools.partial(jax.jit, static_argnames=("M", "maxps", "out_cols"))
def votes_assemble(aligned, ins, feasible, mids, centers_mol, clen_mol,
                   M: int, maxps: int, out_cols: int):
    """segment_votes + assemble_votes in one call (single-chip path)."""
    cv, iv, pc = segment_votes(aligned, ins, feasible, mids, M)
    return assemble_votes(cv, iv, pc, centers_mol, clen_mol, maxps,
                          out_cols)


def merge_download(packed, out_len, overflow):
    """One [M, out_cols + 5] u8 download: consensus bytes | out_len LE32
    | overflow."""
    ol = out_len[:, None].astype(jnp.uint32)
    lb = jnp.concatenate([((ol >> s) & 0xFF).astype(jnp.uint8)
                          for s in (0, 8, 16, 24)], axis=1)
    return jnp.concatenate([packed, lb, overflow[:, None].astype(jnp.uint8)],
                           axis=1)


def consensus_oracle(molecules, minps: int = 3, maxps: int = 20):
    """The plain reference of the device route: per bucket, the engine's
    own pair selection fed to `consensus_votes` at the bucket's band
    width, then the host `_assemble`. The device route must reproduce it
    byte for byte."""
    eng = BatchedConsensusEngine()
    out: list = [None] * len(molecules)
    buckets: dict[int, list[int]] = defaultdict(list)
    for mi, seqs in enumerate(molecules):
        if len(seqs) <= 2:
            out[mi] = poa.consensus_reads(seqs, minps, maxps)
        else:
            c = max(len(x) for x in seqs)
            buckets[max(256, 1 << (c - 1).bit_length())].append(mi)
    for Lc, idxs in buckets.items():
        W = w_for(Lc)
        info, centers, clens, reads, rlens, mol_ids = eng._build_bucket(
            molecules, idxs, Lc, W)
        if not centers:
            for mi, _, _ in info:
                out[mi] = poa.consensus_reads(molecules[mi], minps, maxps)
            continue
        P = len(centers)
        c_arr = np.full((P, Lc), dna.PAD, np.int8)
        r_arr = np.full((P, Lc + W), dna.PAD, np.int8)
        for p in range(P):
            c_arr[p, :clens[p]] = dna.encode(centers[p])
            r_arr[p, :rlens[p]] = dna.encode(reads[p])
        cv, iv, pc = (np.asarray(x) for x in consensus_votes(
            jnp.asarray(c_arr), jnp.asarray(np.int32(clens)),
            jnp.asarray(r_arr), jnp.asarray(np.int32(rlens)),
            jnp.asarray(np.int32(mol_ids)), W, len(info)))
        for m_local, (mi, cseq, _) in enumerate(info):
            out[mi] = BatchedConsensusEngine._assemble(
                cseq, cv[m_local], iv[m_local], int(pc[m_local]), maxps)
    return out


class BatchedConsensusEngine:
    """Bucketed molecule batches -> device alignment + assembly -> strings.

    Call with a list of per-molecule read lists; returns [(cons, qv)] in
    order, matching ops.poa.consensus_reads dispatch (1 read -> itself,
    2 -> longest, >=3 -> MSA consensus).

    One device route: 2-bit uploads -> band_align -> votes_assemble on the
    device -> compacted consensus download. Molecules the 2-bit upload or
    the 6-bit QV byte cannot carry (N bases, centers beyond
    max_center_len, maxps > 63) take the host engine (ops.poa)."""

    def __init__(self, maxreads: int = 20, max_center_len: int = 2048,
                 mesh=None, data_axis: str = "data"):
        """`mesh`: a jax.sharding.Mesh — pair batches shard over
        `data_axis` and per-molecule votes psum-merge (multi-device
        consensus as a pipeline mode; results identical to one device)."""
        self.maxreads = maxreads
        self.max_center_len = max_center_len
        self.mesh = mesh
        self.data_axis = data_axis
        self._gran = int(mesh.shape[data_axis]) if mesh is not None else 1
        self._steps: dict = {}

    def __call__(self, molecules: list[list[bytes]], minps: int = 3,
                 maxps: int = 20, refine: bool = False):
        """refine=True runs a SECOND alignment pass with the first-pass
        consensus as the center (every read realigns to it and re-votes) —
        the cheap approximation of spoa's graph refinement. Costs ~2x
        device time; accuracy deltas are tabulated in
        docs/CONSENSUS_ACCURACY.md."""
        results = self._one_pass(molecules, minps, maxps, None)
        if not refine:
            return results
        centers_map = {}
        for mi, seqs in enumerate(molecules):
            if len(seqs) > 2 and results[mi] is not None:
                c = results[mi][0]
                if len(c) and len(c) <= self.max_center_len:
                    centers_map[mi] = c
        if centers_map:
            refined = self._one_pass(molecules, minps, maxps, centers_map)
            for mi in centers_map:
                results[mi] = refined[mi]
        return results

    def _one_pass(self, molecules, minps, maxps, centers_map):
        results: list = [None] * len(molecules)
        # maxps > 63 cannot pack into the 6 qv bits of the compacted
        # consensus byte: such calls run on the host engine
        device = maxps <= 63
        # bucket multi-read molecules by center length
        buckets: dict[int, list[int]] = defaultdict(list)
        for mi, seqs in enumerate(molecules):
            if centers_map is not None and mi not in centers_map:
                continue
            if len(seqs) <= 2:
                results[mi] = poa.consensus_reads(seqs, minps, maxps)
                continue
            c = (len(centers_map[mi]) if centers_map is not None
                 else max(len(s) for s in seqs))
            if (not device or c > self.max_center_len
                    or any(s.translate(None, _ACGT) for s in seqs)):
                # 2-bit device uploads cannot carry N/ambiguity codes;
                # N-containing molecules (rare in ONT basecalls) take
                # the host engine — same algorithm, N never matches
                results[mi] = poa.consensus_reads(seqs, minps, maxps)
            else:
                buckets[max(256, 1 << (c - 1).bit_length())].append(mi)
        self._run_device(molecules, buckets, results, minps, maxps,
                         centers_map)
        return results

    def _build_bucket(self, molecules, idxs, Lc, W, centers_map=None):
        """Pack one bucket's pair batch; returns None when no pairs.

        With centers_map the given consensus is the center and EVERY read
        forms a pair (refine pass); otherwise the longest read is the
        center and the others pair against it."""
        centers, clens, reads, rlens, mol_ids = [], [], [], [], []
        info = []  # per molecule in bucket: (mi, center_seq, R)
        for m_local, mi in enumerate(idxs):
            seqs = molecules[mi]
            if centers_map is not None:
                cseq = centers_map[mi]
                ci = -1
            else:
                ci = max(range(len(seqs)), key=lambda i: len(seqs[i]))
                cseq = seqs[ci]
            info.append((mi, cseq, len(seqs)))
            for r, s in enumerate(seqs):
                if r == ci:
                    continue
                # drop reads whose length diff exceeds the band
                if abs(len(s) - len(cseq)) >= W // 2 - 4:
                    continue
                centers.append(cseq)
                clens.append(len(cseq))
                reads.append(s[:Lc + W])
                rlens.append(len(s[:Lc + W]))
                mol_ids.append(m_local)
        return info, centers, clens, reads, rlens, mol_ids

    @staticmethod
    def _grid(n: int, step: int = 1) -> int:
        """Smallest {1, 1.5} x pow2 multiple of `step` >= n — a finer
        padded-size grid than pow2 (worst-case 1.5x vs 2x row waste) at
        ~1.6x the compiled-shape count."""
        k = step
        while k < n:
            if k * 3 // 2 >= n and (k * 3 // 2) % step == 0:
                return k * 3 // 2
            k *= 2
        return k

    def _bucket_fn(self, Lc: int, Pp: int, n2: int, maxps: int,
                   out_cols: int):
        """Fused align+assemble for one bucket shape: ONE coalesced upload
        in, ONE merged [n2, out_cols + 5] u8 array out (consensus bytes |
        out_len LE32 | overflow)."""
        key = (Lc, Pp, n2, maxps, out_cols)
        fn = self._steps.get(key)
        if fn is None:
            W = w_for(Lc)
            E = ((padl_for(W) + Lc + W + 127) // 128) * 128 // 4

            @jax.jit
            def fn(blob):
                o1 = E * Pp
                o2 = o1 + 4 * Pp
                o3 = o2 + 4 * Pp
                o4 = o3 + n2 * (Lc // 4)
                reads2b = blob[:o1].reshape(E, Pp)
                rl = jax.lax.bitcast_convert_type(
                    blob[o1:o2].reshape(Pp, 4), jnp.int32)
                mids = jax.lax.bitcast_convert_type(
                    blob[o2:o3].reshape(Pp, 4), jnp.int32)
                cmol2b = blob[o3:o4].reshape(n2, Lc // 4)
                clm = jax.lax.bitcast_convert_type(
                    blob[o4:].reshape(n2, 4), jnp.int32)
                aligned, ins, feas, cmol = band_align(
                    reads2b, rl, mids, cmol2b, clm, Lc)
                packed, out_len, pc, overflow = votes_assemble(
                    aligned, ins, feas, mids, cmol, clm, n2, maxps,
                    out_cols)
                return merge_download(packed, out_len, overflow)

            self._steps[key] = fn
        return fn

    def _bucket_fn_sharded(self, Lc, Pp, n2, maxps, out_cols):
        """Multi-device bucket step (pairs sharded over the data axis,
        votes psum-merged, assembly replicated). Results byte-identical to
        one device."""
        key = ("sh", Lc, Pp, n2, maxps, out_cols)
        fn = self._steps.get(key)
        if fn is None:
            from sicelore_tpu.parallel.consensus_step import (
                make_sharded_bucket_fn)
            fn = make_sharded_bucket_fn(
                self.mesh, Lc, Pp, n2, maxps, out_cols, self.data_axis)
            self._steps[key] = fn
        return fn

    def _run_device(self, molecules, buckets, results, minps, maxps,
                    centers_map=None):
        """Band-align + on-device assembly per bucket. Uploads are 2-bit
        packed and deduplicated (centers once per MOLECULE, gathered to
        pairs on device); downloads only the compacted per-molecule
        consensus bytes. Every bucket dispatches before the first
        download, so device work overlaps the host decode."""
        pending = []
        for Lc, idxs in buckets.items():
            W = w_for(Lc)
            PADL = padl_for(W)
            built = self._build_bucket(molecules, idxs, Lc, W,
                                       centers_map)
            info, centers, clens, reads, rlens, mol_ids = built
            if not centers:
                for mi, cseq, R in info:
                    results[mi] = poa.consensus_reads(molecules[mi], minps,
                                                      maxps)
                continue
            P = len(centers)
            Pp = self._grid(P, PAIR_STEP * self._gran)
            n = len(info)
            n2 = self._grid(max(8, n + 1))
            Lr = Lc + W
            Lrp = ((PADL + Lr + 127) // 128) * 128
            rT = np.full((Lrp, Pp), 3, np.int8)
            rl = np.zeros(Pp, np.int32)
            mids = np.full(Pp, n, np.int32)  # overflow segment
            cmol = np.zeros((n2, Lc), np.int8)
            clm = np.zeros(n2, np.int32)
            for m_local, (mi, cseq, R) in enumerate(info):
                cmol[m_local, :len(cseq)] = dna.encode(cseq)
                clm[m_local] = len(cseq)
            for p in range(P):
                rT[PADL:PADL + rlens[p], p] = dna.encode(reads[p])
                rl[p], mids[p] = rlens[p], mol_ids[p]
            out_cols = Lc + Lc // 8 + 16
            if self.mesh is not None:
                fn = self._bucket_fn_sharded(Lc, Pp, n2, maxps, out_cols)
                merged = fn(jnp.asarray(pack2bit_cols_np(rT)),
                            jnp.asarray(rl), jnp.asarray(mids),
                            jnp.asarray(pack2bit_rows_np(cmol)),
                            jnp.asarray(clm))
            else:
                fused = self._bucket_fn(Lc, Pp, n2, maxps, out_cols)
                blob = np.concatenate([
                    pack2bit_cols_np(rT).ravel(), rl.view(np.uint8),
                    mids.view(np.uint8), pack2bit_rows_np(cmol).ravel(),
                    clm.view(np.uint8)])
                merged = fused(jnp.asarray(blob))
            merged.copy_to_host_async()
            pending.append((info, merged, out_cols))
        for info, merged, out_cols in pending:
            merged = np.asarray(merged)
            packed = merged[:, :out_cols]
            out_len = (merged[:, out_cols:out_cols + 4]
                       .astype(np.uint32) << np.uint32([0, 8, 16, 24])
                       ).sum(axis=1).astype(np.int64)
            overflow = merged[:, out_cols + 4]
            codes_all = packed & 3
            qs_all = (packed >> 2) + 33
            acgt = np.frombuffer(b"ACGT", np.uint8)
            for m_local, (mi, cseq, R) in enumerate(info):
                if overflow[m_local]:
                    results[mi] = poa.consensus_reads(molecules[mi], minps,
                                                      maxps)
                    continue
                n = int(out_len[m_local])
                cons = acgt[codes_all[m_local, :n]].tobytes()
                qv = qs_all[m_local, :n].astype(np.uint8).tobytes()
                results[mi] = (cons, qv)

    @staticmethod
    def _assemble(center: bytes, col_votes, ins_votes, n_pairs, maxps):
        """Majority consensus + QV from vote tensors (host, vectorized) —
        with `consensus_votes`, the plain oracle the device route is
        tested against.

        R = n_pairs + 1 (center votes its own base per column; reads
        without an insertion vote gap in insertion columns). Emission
        order per center position j: insertion columns (offset o
        descending — right-justified trace order), then base column j;
        majority-deletion columns are dropped (gap stripped)."""
        lc = len(center)
        R = n_pairs + 1
        ccodes = np.minimum(dna.encode(center), 4).astype(np.int64)
        cv = np.asarray(col_votes[:lc])            # [lc, 5]
        iv = np.asarray(ins_votes[:lc + 1])        # [lc+1, K, 4]
        K = K_INS
        # slot layout: row j holds K insertion slots (o = K-1..0) then the
        # base slot; total (lc+1)*(K+1) slots, last row's base slot unused
        S = (lc + 1) * (K + 1)
        code = np.zeros(S, np.int64)
        win = np.zeros(S, np.int64)
        keep = np.zeros(S, bool)
        # insertion slots: argmax base wins iff votes > gap votes (R - sum)
        ib = iv.argmax(axis=2)                     # [lc+1, K]
        ivw = np.take_along_axis(iv, ib[:, :, None], axis=2)[:, :, 0]
        ikeep = (ivw > R - iv.sum(axis=2)) & (ivw > 0)
        slots = (np.arange(lc + 1)[:, None] * (K + 1)
                 + (K - 1 - np.arange(K))[None, :])
        code[slots.ravel()] = ib.ravel()
        win[slots.ravel()] = ivw.ravel()
        keep[slots.ravel()] = ikeep.ravel()
        # base slots: center's own base votes too
        if lc:
            cv = cv.copy()
            np.add.at(cv, (np.arange(lc), ccodes), 1)
            bb = cv.argmax(axis=1)                 # [lc]
            bw = np.take_along_axis(cv, bb[:, None], axis=1)[:, 0]
            bslots = np.arange(lc) * (K + 1) + K
            code[bslots] = bb
            win[bslots] = bw
            keep[bslots] = bb != 4
        code, win = code[keep], win[keep]
        out = np.frombuffer(b"ACGT", np.uint8)[np.minimum(code, 3)].tobytes()
        frac = win / R
        q = np.rint(-10 * np.log10(np.maximum(1.0 - frac, 1e-9)))
        q = np.where(frac >= 1.0, maxps, np.minimum(q, maxps))
        return out, (q.astype(np.uint8) + 33).tobytes()
