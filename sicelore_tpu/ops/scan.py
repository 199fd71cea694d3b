"""Read-scan compute ops: polyA/T window scan + adapter/TSO alignment search.

Equivalents of the reference jar's readscan analyzers
(PolyATSearcher / PolyATadapterAnalyzer_{3p,5p}BCUMI and AdapterTSOanalyzer /
NeedlemanMatch; behavior spec: the reference config.xml readscanner
sections, summarized in SURVEY.md):

  * polyA/T: find a run of >= polyATlength bases with >= fractionATInPolyAT
    A (or T) within windowSearchForPolyA of a read end; also detect internal
    runs (chimera evidence).
  * adapter/TSO: approximate search of the adapter pattern in a bounded
    window, bounded mismatch count; TSO additionally passes on consecutive-
    match criteria.

All ops are fixed-shape jnp over [B, L] int8 code batches (XLA fuses the
rolling sums / scans); the adapter search reuses the Myers bit-parallel
machinery from ops.editdist with the pattern bitmask replicated per-window.

Policy notes (the jar is binary-only; exact internals are unobservable):
  * "run" = maximal stretch of positions whose k-length window passes the
    count threshold, reported as [first passing window start,
    last passing window end], then tightened to the first/last base equal to
    the target base inside that stretch.
  * adapter "mismatches" = unit-cost edit distance of the pattern vs the
    window (substitutions and indels), matching the spirit of the NW
    mismatch bound.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sicelore_tpu.ops import editdist
from sicelore_tpu.utils import dna

NEG = -(10**9)


def _rolling_count(ind: jax.Array, k: int) -> jax.Array:
    """ind [B, L] 0/1 -> [B, L-k+1] window sums via cumulative sum."""
    cs = jnp.cumsum(ind, axis=1)
    zero = jnp.zeros((ind.shape[0], 1), dtype=cs.dtype)
    cs = jnp.concatenate([zero, cs], axis=1)  # cs[:, i] = sum of first i
    return cs[:, k:] - cs[:, :-k]


@functools.partial(jax.jit, static_argnames=("base", "k", "from_end"))
def polyat_find(seqs: jax.Array, lens: jax.Array, *, base: int, k: int,
                min_count: int, window: int, from_end: bool,
                start_min: jax.Array | None = None):
    """Find the polyA/T run nearest a read end.

    Args:
      seqs: [B, L] int8 codes. lens: [B] int32 true lengths.
      base: dna.A or dna.T. k: minimal run length (window size).
      min_count: minimal #base within each k-window (ceil(frac*k)).
      window: max distance of the run end from the read end (3') or of the
        run start from the read start (5').
      from_end: True -> polyA near 3' end; False -> polyT near 5' start.
      start_min: optional [B] int32 — window starts below this are not
        in-read (right-aligned tail halves of the two-half composite, where
        the read START sits mid-array; see ops.edgescan).
    Returns:
      found [B] bool, start [B] int32, end [B] int32 (inclusive, 0-based,
      tightened to first/last `base`), both -1 when not found.
    """
    B, L = seqs.shape
    if L < k:
        z = jnp.zeros((B,), jnp.int32)
        return jnp.zeros((B,), bool), z - 1, z - 1
    ind = (seqs == base).astype(jnp.int32)
    counts = _rolling_count(ind, k)  # [B, L-k+1]
    npos = L - k + 1
    pos = jnp.arange(npos, dtype=jnp.int32)[None, :]
    # window start positions must lie within the read
    inread = pos <= (lens[:, None] - k)
    if start_min is not None:
        inread &= pos >= start_min[:, None]
    passing = (counts >= min_count) & inread
    if from_end:
        # run end (pos + k - 1) within `window` of the read end
        region = (pos + k - 1) >= (lens[:, None] - window)
    else:
        region = pos < window
    ok = passing & region

    idx = jnp.arange(npos, dtype=jnp.int32)[None, :]
    if from_end:
        # pick the LAST passing window (closest to 3' end), walk its run left
        j = jnp.max(jnp.where(ok, idx, NEG), axis=1)  # [B]
        found = j > NEG
        jc = jnp.maximum(j, 0)
        # last non-passing index before each position (over `passing`, so the
        # run may extend left beyond the region boundary)
        lf = jax.lax.associative_scan(jnp.maximum,
                                      jnp.where(~passing, idx, NEG), axis=1)
        run_start = jnp.take_along_axis(lf, jc[:, None], axis=1)[:, 0] + 1
        run_start = jnp.maximum(run_start, 0)
        start, end = run_start, jc + k - 1
    else:
        # pick the FIRST passing window (closest to 5' start), walk right
        j = jnp.min(jnp.where(ok, idx, -NEG), axis=1)
        found = j < -NEG
        jc = jnp.minimum(jnp.maximum(j, 0), npos - 1)
        rf = jax.lax.associative_scan(jnp.minimum,
                                      jnp.where(~passing, idx, -NEG), axis=1,
                                      reverse=True)
        run_end = jnp.take_along_axis(rf, jc[:, None], axis=1)[:, 0] - 1
        run_end = jnp.minimum(run_end, npos - 1)
        start, end = jc, run_end + k - 1
    end = jnp.minimum(end, lens - 1)

    # tighten to actual first/last target base within [start, end]
    cols = jnp.arange(L, dtype=jnp.int32)[None, :]
    inseg = (cols >= start[:, None]) & (cols <= end[:, None]) & (seqs == base)
    first = jnp.min(jnp.where(inseg, cols, -NEG), axis=1)
    last = jnp.max(jnp.where(inseg, cols, NEG), axis=1)
    has_base = last > NEG
    found = found & has_base
    start = jnp.where(found, first, -1).astype(jnp.int32)
    end = jnp.where(found, last, -1).astype(jnp.int32)
    return found, start, end


@functools.partial(jax.jit, static_argnames=("base", "k", "edge_exclusion"))
def internal_polyat(seqs: jax.Array, lens: jax.Array, *, base: int, k: int,
                    min_count: int, edge_exclusion: int):
    """Detect polyA/T runs away from both read ends (chimera evidence).

    Returns found [B] bool and the start position [B] int32 of the first
    internal passing window (-1 when none). Reference behavior: internal
    polyA triggers internal-adapter search for chimera splitting
    (config.xml:97-105, ChimeraFindernew).
    """
    B, L = seqs.shape
    if L < k:
        z = jnp.zeros((B,), jnp.int32)
        return jnp.zeros((B,), bool), z - 1
    ind = (seqs == base).astype(jnp.int32)
    counts = _rolling_count(ind, k)
    npos = L - k + 1
    pos = jnp.arange(npos, dtype=jnp.int32)[None, :]
    inread = pos <= (lens[:, None] - k)
    internal = (pos >= edge_exclusion) & ((pos + k - 1) < (lens[:, None] - edge_exclusion))
    ok = (counts >= min_count) & inread & internal
    idx = jnp.arange(npos, dtype=jnp.int32)[None, :]
    j = jnp.min(jnp.where(ok, idx, -NEG), axis=1)
    found = j < -NEG
    return found, jnp.where(found, j, -1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("m",))
def adapter_search(windows: jax.Array, peq1: jax.Array, m: int):
    """Search one adapter pattern in each read window (semi-global ED).

    windows [B, W] int8; peq1 [4, 1] uint32 (single pattern).
    Returns ed [B] int32 and end_pos [B] int32 (0-based last matched char in
    the window; ties -> first)."""
    ed, pos = editdist.myers_sweep(windows, peq1, m)
    return ed[:, 0], pos[:, 0]


@functools.partial(jax.jit, static_argnames=("m",))
def match_run_stats(windows: jax.Array, pattern: jax.Array, m: int):
    """Longest and second-longest co-linear exact match runs of pattern in
    each window (TSO consecutive-match criteria, config.xml:160-166).

    run DP: run[i, j] = pattern[i] == window[j] ? run[i-1, j-1] + 1 : 0.
    The two best runs are taken on disjoint diagonals (policy: approximates
    "two best consecutive matches in one NW alignment").

    windows [B, W] int8; pattern [m] int8. Returns (best [B], second [B]).
    """
    B, W = windows.shape

    def row(carry, pc):
        prev, best_per_diag = carry  # prev: [B, W] run ending at previous i
        eq = (windows == pc) & (pc < 4)
        shifted = jnp.pad(prev[:, :-1], ((0, 0), (1, 0)))
        cur = jnp.where(eq, shifted + 1, 0)
        # diagonal d = j - i is constant along a run; track per-j max is
        # enough since runs on the same diagonal overlap in j
        best_per_diag = jnp.maximum(best_per_diag, cur)
        return (cur, best_per_diag), None

    init = (jnp.zeros((B, W), jnp.int32), jnp.zeros((B, W), jnp.int32))
    (_, best_end), _ = jax.lax.scan(row, init, pattern.astype(jnp.int8),
                                    unroll=editdist.UNROLL)
    # best_end[b, j] = longest run ending at window pos j (any i)
    best = jnp.max(best_end, axis=1)
    jbest = jnp.argmax(best_end, axis=1).astype(jnp.int32)
    # exclude window positions covered by the best run, take max again
    cols = jnp.arange(W, dtype=jnp.int32)[None, :]
    covered = (cols > (jbest - best)[:, None]) & (cols <= jbest[:, None])
    second = jnp.max(jnp.where(covered, 0, best_end), axis=1)
    return best, second


@functools.partial(jax.jit, static_argnames=("m", "c1", "c2"))
def run_bailout(windows: jax.Array, pattern: jax.Array, m: int,
                c1: int, c2: int):
    """TSO consecutive-match bailout (config.xml:160-166): True when the
    window holds a diagonal exact-match run >= c1, or two COLUMN-DISJOINT
    runs summing >= c2 (policy: the jar's "two best consecutive matches in
    one NW alignment" is unobservable; column-disjointness is the
    deterministic analog, and it decomposes into threshold pairs
    (a, c2-a) for a in [ceil(c2/2), c1) — any pair with a side >= c1 is
    already covered by the first test, and a single run long enough to
    fake a pair has length >= c2 >= c1, also covered).

    windows [B, W] int8; pattern [m] int8. Returns [B] bool.
    """
    assert c2 >= c1, "two-best threshold below single-run threshold"
    B, W = windows.shape

    def row(prev, pc):
        eq = (windows == pc) & (pc < 4)
        shifted = jnp.pad(prev[:, :-1], ((0, 0), (1, 0)))
        cur = jnp.where(eq, shifted + 1, 0)
        return cur, cur

    init = jnp.zeros((B, W), jnp.int32)
    _, allruns = jax.lax.scan(row, init, pattern.astype(jnp.int8),
                              unroll=editdist.UNROLL)
    best_end = jnp.max(allruns, axis=0)          # [B, W]: longest run @ j
    ok = jnp.any(best_end >= c1, axis=1)
    for a in range((c2 + 1) // 2, min(c1, c2)):
        b = c2 - a
        if b < 1:
            continue
        for x, y in {(a, b), (b, a)}:
            ey = jax.lax.associative_scan(jnp.maximum,
                                          (best_end >= y).astype(jnp.int32),
                                          axis=1)
            eyd = jnp.pad(ey[:, :-x], ((0, 0), (x, 0)))  # E_y at col j-x
            ok = ok | jnp.any((best_end >= x) & (eyd > 0), axis=1)
    return ok


def peq_single(pattern: str | bytes | np.ndarray) -> tuple[np.ndarray, int]:
    """Build a [4, 1] Peq for a single ASCII pattern; returns (peq, m)."""
    codes = dna.encode(pattern) if isinstance(pattern, (str, bytes)) else pattern
    return editdist.build_peq(codes[None, :]), len(codes)


def min_count_for(k: int, frac: float) -> int:
    """ceil(frac * k) as the integer pass threshold."""
    return int(np.ceil(frac * k - 1e-9))
