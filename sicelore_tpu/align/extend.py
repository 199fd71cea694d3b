"""Between-anchor gap alignment -> CIGAR, batched on the device.

Chains give exact-match anchors; the sequence between consecutive anchors
aligns as:

  * diagonal runs (ref gap == query gap) -> M
  * introns (ref gap - query gap >= MIN_INTRON) -> N, junction snapped to
    the closest GT..AG donor/acceptor within SNAP bp of the anchor bound
  * ordinary gaps -> banded NW through the SAME band alignment as the
    consensus engine (ops/poa_tpu.band_align): the ref segment is the
    "center", the query segment the "read", and the walk records decode
    into M/I/D runs (aligned: base=M, 4=D; per-column insertion counts).
    Gaps outside the band envelope emit plain I+D runs (rare; still valid
    SAM).

All gap pairs of a read batch ride one device call per length bucket —
the same fixed-shape batching discipline as every other device stage.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

MIN_INTRON = 30
SNAP = 12
MAX_SEG = 1000          # device-aligned gap segment cap


def _merge(ops: list, op: str, n: int):
    if n <= 0:
        return
    if ops and ops[-1][0] == op:
        ops[-1][1] += n
    else:
        ops.append([op, n])


def cigar_from_alignment(aligned_row: np.ndarray, ins_sums: np.ndarray,
                         clen: int) -> list:
    """Band-align walk records -> M/I/D runs for one (ref=center, query)
    pair.

    aligned_row [Lc+1]: slot t describes center col t+1 (code<4 = M,
    4 = D); ins_sums [Lc+1]: row r counts query insertions between center
    col r and r+1 (row 0 = before the first). Vectorized RLE — the
    round-4 per-column Python loop was ~70% of noisy-batch wall."""
    a = np.asarray(aligned_row[:clen])
    ins = np.asarray(ins_sums[:clen + 1])
    ops: list = []
    _merge(ops, "I", int(ins[0]))
    if clen == 0:
        return ops
    hot = np.nonzero(ins[1:])[0]        # columns followed by insertions
    # M/D runs between insertion break points
    code = np.where(a < 4, 0, 1)        # 0 = M, 1 = D
    prev = 0
    bounds = list(hot.tolist()) + ([clen - 1] if (len(hot) == 0 or
                                                  hot[-1] != clen - 1)
                                   else [])
    for b in bounds:
        seg = code[prev:b + 1]
        if len(seg):
            # RLE of the M/D codes in this segment
            cuts = np.nonzero(np.diff(seg))[0]
            starts = np.concatenate([[0], cuts + 1])
            ends = np.concatenate([cuts + 1, [len(seg)]])
            for st, en in zip(starts.tolist(), ends.tolist()):
                _merge(ops, "M" if seg[st] == 0 else "D", en - st)
        _merge(ops, "I", int(ins[b + 1]))
        prev = b + 1
    return ops


def snap_junction(ref: bytes, jpos: int, intron: int) -> int:
    """Shift an intron start near jpos (global coords within `ref`) to the
    nearest GT..AG motif within +-SNAP bp; returns the snapped start."""
    best = jpos
    for d in range(-SNAP, SNAP + 1):
        s = jpos + d
        if s < 0 or s + intron + 2 > len(ref):
            continue
        if ref[s:s + 2] == b"GT" and ref[s + intron - 2:s + intron] == b"AG":
            if abs(d) < abs(best - jpos) or best == jpos:
                best = s
                if d == 0:
                    break
    return best


class GapBatcher:
    """Collects ordinary gap pairs across a read batch and aligns them in
    one device sweep per bucket through the consensus band alignment."""

    def __init__(self):
        self.jobs: dict[int, list] = defaultdict(list)  # Lc -> [(id, R, Q)]
        self.results: dict[int, list] = {}

    def feasible(self, R: bytes, Q: bytes) -> bool:
        from sicelore_tpu.ops import poa_tpu
        if not (1 <= len(R) <= MAX_SEG and 1 <= len(Q) <= MAX_SEG):
            return False
        # the 2-bit uploads cannot carry N (assembly-gap runs in
        # the reference genome): those segments take the plain I+D path
        if R.translate(None, poa_tpu._ACGT) or Q.translate(
                None, poa_tpu._ACGT):
            return False
        Lc = max(64, 1 << (len(R) - 1).bit_length())
        W = poa_tpu.w_for(Lc)
        return abs(len(R) - len(Q)) < W // 2 - 4

    def add(self, R: bytes, Q: bytes) -> int:
        Lc = max(64, 1 << (len(R) - 1).bit_length())
        jid = len(self.jobs[Lc])
        self.jobs[Lc].append((R, Q))
        return (Lc << 20) | jid

    def run(self):
        """Align all collected pairs; results retrievable via get()."""
        import jax.numpy as jnp

        from sicelore_tpu.ops import poa_tpu
        from sicelore_tpu.utils import dna
        for Lc, pairs in self.jobs.items():
            P = len(pairs)
            W = poa_tpu.w_for(Lc)
            PADL = poa_tpu.padl_for(W)
            Lrp = ((PADL + Lc + W + 127) // 128) * 128
            Pp = max(poa_tpu.PAIR_STEP, 1 << (P - 1).bit_length())
            # v2 upload layout: each gap pair is its own "molecule"
            # (mids = identity), 2-bit packed like the consensus engine
            cmol = np.zeros((Pp, Lc), np.int8)
            rT = np.full((Lrp, Pp), 3, np.int8)
            cl = np.zeros(Pp, np.int32)
            rl = np.zeros(Pp, np.int32)
            for p, (R, Q) in enumerate(pairs):
                cmol[p, :len(R)] = dna.encode(R)
                rT[PADL:PADL + len(Q), p] = dna.encode(Q)
                cl[p] = len(R)
                rl[p] = len(Q)
            mids = np.arange(Pp, dtype=np.int32)
            fn = _gap_fn(Lc)
            aligned, ins_sums, feas = fn(
                jnp.asarray(poa_tpu.pack2bit_cols_np(rT)),
                jnp.asarray(rl), jnp.asarray(mids),
                jnp.asarray(poa_tpu.pack2bit_rows_np(cmol)),
                jnp.asarray(cl))
            self.results[Lc] = (np.asarray(aligned),
                                np.asarray(ins_sums),
                                np.asarray(feas))

    def get(self, handle: int, R: bytes, Q: bytes) -> list:
        """CIGAR ops for a previously-added pair (fallback to plain I/D
        when the band alignment was infeasible)."""
        Lc, jid = handle >> 20, handle & 0xFFFFF
        aligned, ins_sums, feas = self.results[Lc]
        if not feas[jid]:
            return plain_gap_ops(len(R), len(Q))
        return cigar_from_alignment(aligned[jid], ins_sums[jid], len(R))


_GAP_FNS: dict = {}


def _gap_fn(Lc: int):
    """Per-Lc jitted band alignment -> (aligned, per-column insertion
    totals, feasible)."""
    fn = _GAP_FNS.get(Lc)
    if fn is None:
        import jax
        import jax.numpy as jnp

        from sicelore_tpu.ops import poa_tpu

        @jax.jit
        def fn(r2b, rl, mids, cm2b, clm):
            aligned, ins, feas, _ = poa_tpu.band_align(
                r2b, rl, mids, cm2b, clm, Lc)
            # per-column insertion totals on device: [P, Lc+1] i8 (totals
            # <= band width < 128) instead of the [P, Lc+1, K, 4] votes
            isum = ins.astype(jnp.int32).sum(axis=(2, 3)).astype(jnp.int8)
            return aligned, isum, feas

        _GAP_FNS[Lc] = fn
    return fn


def plain_gap_ops(ref_len: int, q_len: int) -> list:
    """Coarse gap emission when banded alignment is not applicable."""
    ops: list = []
    m = min(ref_len, q_len)
    _merge(ops, "M", m)
    _merge(ops, "I", q_len - m)
    _merge(ops, "D", ref_len - m)
    return ops
