"""Myers bit-parallel edit distance (jnp; XLA fuses the unrolled text loop).

Replacement for the reference's cell-barcode/UMI edit-distance machinery
(jar classes BCnucTwoBitPerBaseEDtester / UMInucTwoBitPerBaseEDtester:
neighborhood enumeration of 2-bit-encoded mutated sequences probed against a
hash set). Here the whole used-barcode list is swept per read with Hyyrö/Myers
bit-parallel approximate matching: state for (read, barcode) pairs is two
uint32 bit-vectors updated with ~15 integer ops per text char, vectorized
over [reads, barcodes] (ops.bcsearch holds the fused sweep + top-2).

Semantics:
  * `myers_sweep` — semi-global search: min edit distance of each pattern
    against any substring of each read window (free text start/end).
    Equivalent to the reference's "search at adapter-predicted position
    +/- testPlusMinusPos with indels" when the window is sliced to
    predicted_start - pad .. predicted_end + pad (config.xml:35).
  * `myers_global_pairwise` — plain Levenshtein between sequences (used for
    UMI clustering distances, matching the jar's apachemod LevenshteinDistance).

Patterns are encoded once into Peq bitmask tensors: Peq[c, n] has bit i set
iff pattern n position i equals base c. The horizontal carry-in bit selects
the variant: shifting 1 into Ph encodes D[0][j] = j (global distance);
shifting 0 encodes D[0][j] = 0 (search with free text start).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sicelore_tpu.utils import dna

INT_MAX = 2**31 - 1  # reference reports ed_sec=2147483647 when none found
UNROLL = 8           # text characters fused per scan step


# ---------------------------------------------------------------------------
# Host-side pattern preparation
# ---------------------------------------------------------------------------

def build_peq(patterns: np.ndarray) -> np.ndarray:
    """[N, m] int8 codes -> Peq uint32 [4, N]; bit i of Peq[c, n] set iff
    patterns[n, i] == c. m must be <= 32."""
    n, m = patterns.shape
    assert m <= 32, "pattern longer than 32 bases; split or widen word"
    peq = np.zeros((4, n), dtype=np.uint32)
    for i in range(m):
        for c in range(4):
            peq[c] |= ((patterns[:, i] == c).astype(np.uint32)) << np.uint32(i)
    return peq


# ---------------------------------------------------------------------------
# Reference scalar implementations (for tests)
# ---------------------------------------------------------------------------

def levenshtein_np(a, b) -> int:
    """Plain Levenshtein distance between two code arrays / strings."""
    if isinstance(a, (str, bytes)):
        a = dna.encode(a)
    if isinstance(b, (str, bytes)):
        b = dna.encode(b)
    la, lb = len(a), len(b)
    prev = np.arange(lb + 1)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, dtype=np.int64)
        cur[0] = i
        for j in range(1, lb + 1):
            cost = 0 if (a[i - 1] == b[j - 1] and a[i - 1] < 4) else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return int(prev[lb])


def semiglobal_ed_np(pattern, text) -> tuple[int, int]:
    """Min ED of pattern vs any substring of text; returns (ed, end_pos).

    end_pos is the 0-based index of the last text char of the best match
    (first position on ties, matching the device kernel)."""
    if isinstance(pattern, (str, bytes)):
        pattern = dna.encode(pattern)
    if isinstance(text, (str, bytes)):
        text = dna.encode(text)
    m, w = len(pattern), len(text)
    col = np.arange(m + 1)  # D[i][0] = i
    best, best_pos = m, -1
    for j in range(1, w + 1):
        newcol = np.empty(m + 1, dtype=np.int64)
        newcol[0] = 0  # free text start
        for i in range(1, m + 1):
            cost = 0 if (pattern[i - 1] == text[j - 1] and pattern[i - 1] < 4) else 1
            newcol[i] = min(col[i] + 1, newcol[i - 1] + 1, col[i - 1] + cost)
        col = newcol
        if col[m] < best:
            best, best_pos = int(col[m]), j - 1
    return best, best_pos


def semiglobal_ed_np_batch(patterns: np.ndarray, texts: np.ndarray):
    """Vectorized numpy reference of `myers_sweep` (for tests).

    patterns [N, m] int8, texts [B, W] int8 -> (ed [B, N], end_pos [B, N]).
    """
    N, m = patterns.shape
    B, W = texts.shape
    col = np.broadcast_to(np.arange(m + 1)[None, None, :], (B, N, m + 1)).copy()
    best = np.full((B, N), m, dtype=np.int64)
    best_pos = np.full((B, N), -1, dtype=np.int64)
    for j in range(W):
        tc = texts[:, j][:, None, None]  # [B,1,1]
        match = (patterns[None, :, :] == tc) & (patterns[None, :, :] < 4) & (tc < 4)
        newcol = np.empty_like(col)
        newcol[:, :, 0] = 0
        for i in range(1, m + 1):
            newcol[:, :, i] = np.minimum(
                np.minimum(col[:, :, i] + 1, newcol[:, :, i - 1] + 1),
                col[:, :, i - 1] + (~match[:, :, i - 1]).astype(np.int64))
        col = newcol
        better = col[:, :, m] < best
        best_pos = np.where(better, j, best_pos)
        best = np.where(better, col[:, :, m], best)
    return best, best_pos


# ---------------------------------------------------------------------------
# Shared Hyyrö update
# ---------------------------------------------------------------------------

def _hyyro_step(PV, MV, score, eq, hibit, carry_in):
    """One Hyyrö column update. carry_in=1 -> global distance (D[0][j] = j),
    carry_in=0 -> search with free text start (D[0][j] = 0)."""
    Xv = eq | MV
    Xh = (((eq & PV) + PV) ^ PV) | eq
    Ph = MV | ~(Xh | PV)
    Mh = PV & Xh
    score = score + ((Ph >> hibit) & jnp.uint32(1)).astype(jnp.int32)
    score = score - ((Mh >> hibit) & jnp.uint32(1)).astype(jnp.int32)
    Ph = (Ph << jnp.uint32(1)) | jnp.uint32(carry_in)
    Mh = Mh << jnp.uint32(1)
    PV = Mh | ~(Xv | Ph)
    MV = Ph & Xv
    return PV, MV, score


def _eq_select(tc, peq):
    """Gather Peq rows by text char: tc [...] int8, peq [4, N] uint32 ->
    eq [..., N] (0 where tc is N/PAD, so those positions never match)."""
    z = jnp.uint32(0)
    return jnp.where((tc == 0)[..., None], peq[0],
            jnp.where((tc == 1)[..., None], peq[1],
             jnp.where((tc == 2)[..., None], peq[2],
              jnp.where((tc == 3)[..., None], peq[3], z))))


# ---------------------------------------------------------------------------
# jnp implementations (the text loops are partly unrolled scans: the state
# per step is a few uint32 words per (read, pattern) lane, so XLA fuses
# UNROLL characters per loop step; a fully unrolled chain makes XLA's
# compile time grow steeply with its length)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("m",))
def myers_sweep(windows: jax.Array, peq: jax.Array, m: int):
    """Semi-global ED sweep: every pattern against every read window.

    Args:
      windows: [B, W] int8 base codes (PAD/N never match).
      peq: [4, N] uint32 pattern bitmasks from `build_peq`.
      m: pattern length (static).
    Returns:
      ed [B, N] int32, end_pos [B, N] int32 (0-based last text char of the
      best match; first position on ties; -1 only if W == 0).
    """
    B, W = windows.shape
    N = peq.shape[1]
    hibit = jnp.uint32(m - 1)

    def step(carry, inp):
        PV, MV, score, best, best_pos = carry
        wc, t = inp  # wc: [B] codes at position t
        eq = _eq_select(wc, peq)  # [B, N]
        PV, MV, score = _hyyro_step(PV, MV, score, eq, hibit, 0)
        improved = score < best
        best = jnp.where(improved, score, best)
        best_pos = jnp.where(improved, t, best_pos)
        return (PV, MV, score, best, best_pos), None

    full = jnp.uint32((1 << m) - 1) if m < 32 else jnp.uint32(0xFFFFFFFF)
    PV0 = jnp.full((B, N), full, dtype=jnp.uint32)
    MV0 = jnp.zeros((B, N), dtype=jnp.uint32)
    s0 = jnp.full((B, N), m, dtype=jnp.int32)
    bp0 = jnp.full((B, N), -1, dtype=jnp.int32)
    (_, _, _, best, best_pos), _ = jax.lax.scan(
        step, (PV0, MV0, s0, s0, bp0),
        (windows.T.astype(jnp.int8), jnp.arange(W, dtype=jnp.int32)),
        unroll=UNROLL)
    return best, best_pos


@jax.jit
def best_two(ed: jax.Array):
    """Per row: (best_ed, best_idx, second_ed, second_idx) over axis 1."""
    B, N = ed.shape
    best = jnp.min(ed, axis=1)
    idx = jnp.argmin(ed, axis=1).astype(jnp.int32)
    masked = jnp.where(jnp.arange(N)[None, :] == idx[:, None], INT_MAX, ed)
    second = jnp.min(masked, axis=1)
    second_idx = jnp.argmin(masked, axis=1).astype(jnp.int32)
    return best, idx, second, second_idx


@functools.partial(jax.jit, static_argnames=("m",))
def myers_global_pairwise(peq_g: jax.Array, texts: jax.Array, tlens: jax.Array, m: int):
    """Global Levenshtein of pattern i vs text j for all pairs per group.

    Used for the UMI-clustering distance matrix (reference: jar
    com/rw/clustering/DistanceMatrix over 2-bit testers).

    Args:
      peq_g: [G, 4, P] uint32 — per group, Peq of the P patterns (UMIs).
      texts: [G, K, L] int8 — K text sequences (P == K for the classic
        square distance matrix; rectangular P != K is supported).
      tlens: [G, K] int32 — true text lengths (score snapshot at length).
      m: pattern length (static); all patterns padded/truncated to m.
    Returns:
      ed [G, P, K] int32 with ed[g, i, j] = Levenshtein(pattern_i, text_j).
      Entries for empty texts (tlens == 0) stay at m.
    """
    G, K, L = texts.shape
    P = peq_g.shape[2]
    hibit = jnp.uint32(m - 1)
    full = jnp.uint32((1 << m) - 1) if m < 32 else jnp.uint32(0xFFFFFFFF)

    def step(carry, inp):
        PV, MV, score, out = carry
        tc, t = inp  # tc: [G, K] char of text j at position t
        # eq[g, i, j] = bitmask of pattern i vs char of text j
        z = jnp.uint32(0)
        eq = jnp.where((tc[:, None, :] == 0), peq_g[:, 0][:, :, None],
              jnp.where((tc[:, None, :] == 1), peq_g[:, 1][:, :, None],
               jnp.where((tc[:, None, :] == 2), peq_g[:, 2][:, :, None],
                jnp.where((tc[:, None, :] == 3), peq_g[:, 3][:, :, None], z))))
        PV, MV, score = _hyyro_step(PV, MV, score, eq, hibit, 1)  # global
        out = jnp.where(tlens[:, None, :] == (t + 1), score, out)
        return (PV, MV, score, out), None

    PV0 = jnp.full((G, P, K), full, dtype=jnp.uint32)
    MV0 = jnp.zeros((G, P, K), dtype=jnp.uint32)
    s0 = jnp.full((G, P, K), m, dtype=jnp.int32)
    out0 = jnp.full((G, P, K), m, dtype=jnp.int32)
    (_, _, _, out), _ = jax.lax.scan(
        step, (PV0, MV0, s0, out0),
        (jnp.moveaxis(texts, 2, 0).astype(jnp.int8), jnp.arange(L, dtype=jnp.int32)))
    return out
