"""Fused read-scan forward step — the framework's flagship device "model".

Design: every read is spliced into a FIXED-SHAPE composite of its
first/last EDGE bases (read ends are where all stranding evidence lives), so
the whole edge scan compiles once for [B, 2*EDGE] regardless of read length.
A separate bucketed internal scan handles chimera-split detection on long
reads only.

The edge scan turns a padded read batch into all per-read results needed by
the scanfastq pipeline (reference jar WorkerReadscanner / PolyATSearcher /
AdapterTSOanalyzer behavior, spec: the reference Jar/config.xml readscanner
sections and README, summarized in SURVEY.md):

  * strand call: polyA near the 3' end (FWD) vs polyT near the 5' start (REV)
  * adapter search downstream of the polyA/T, with the window
    reverse-complemented for FWD so the adapter + barcode always appear in
    sense orientation — one geometry for both strands
  * barcode search window extraction (sense orientation, +/- pad)
  * TSO search in the stranded 5' window
  * mean read / BC-region / X-region QV

The internal scan finds up to K internal polyA/T runs per read and confirms
each with a complete-adapter search (reference ChimeraFindernew), returning
split positions for chimeric reads.

Coordinates returned are in the STRANDED read (reference convention: PS =
first A after cDNA, PE = last A of polyA, AE = last adapter base before the
cell BC; reference Jar/config.xml). For REV reads the stranded
read is revcomp(original); positions map via p -> len-1-p. Composite
coordinates are remapped to true read coordinates on the host
(`remap_composite`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sicelore_tpu.ops import editdist, scan
from sicelore_tpu.utils import dna
from sicelore_tpu.utils.config import PipelineConfig

BIG = 10**9
bcsearch_BIG_MIN = 2**30  # lanes masked by the sweep kernel (ops.bcsearch.BIG)
EDGE = 304  # bases kept from each read end in the composite (>= polyA window
            # 150 + adapter window 110 + slack)


def gather_window(seqs: jax.Array, lens: jax.Array, starts: jax.Array, W: int,
                  rc: bool = False) -> jax.Array:
    """Extract per-row windows seqs[b, starts[b] : starts[b]+W].

    Out-of-read positions (idx < 0 or >= lens[b]) become PAD. With rc=True the
    window is reverse-complemented (in code space) after extraction.
    """
    B, L = seqs.shape
    idx = starts[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    valid = (idx >= 0) & (idx < lens[:, None])
    w = jnp.take_along_axis(seqs, jnp.clip(idx, 0, L - 1).astype(jnp.int32), axis=1)
    w = jnp.where(valid, w, jnp.int8(dna.PAD))
    if rc:
        comp = jnp.asarray(dna._COMP, dtype=jnp.int8)
        w = comp[w][:, ::-1]
    return w


def _mean_qv(quals: jax.Array, lens: jax.Array) -> jax.Array:
    """Mean phred over the true read length. quals [B, L] int8."""
    B, L = quals.shape
    cols = jnp.arange(L, dtype=jnp.int32)[None, :]
    m = cols < lens[:, None]
    s = jnp.sum(jnp.where(m, quals.astype(jnp.float32), 0.0), axis=1)
    return s / jnp.maximum(lens.astype(jnp.float32), 1.0)


def _window_mean_qv(quals: jax.Array, lens: jax.Array, starts: jax.Array,
                    ends: jax.Array) -> jax.Array:
    """Mean phred over [starts, ends] inclusive, clipped to the read."""
    B, L = quals.shape
    cols = jnp.arange(L, dtype=jnp.int32)[None, :]
    m = (cols >= starts[:, None]) & (cols <= ends[:, None]) & (cols < lens[:, None])
    s = jnp.sum(jnp.where(m, quals.astype(jnp.float32), 0.0), axis=1)
    n = jnp.sum(m, axis=1)
    return s / jnp.maximum(n.astype(jnp.float32), 1.0)


@functools.partial(jax.jit, static_argnames=("k", "max_sites", "edge"))
def internal_sites(seqs: jax.Array, lens: jax.Array, *, base: int, k: int,
                   min_count: int, edge: int, max_sites: int = 4):
    """Up to `max_sites` disjoint internal polyA/T runs (chimera candidates).

    Returns (count [B] int32, starts [B, max_sites] int32 window-start
    positions, -1 padded). Reference: ChimeraFindernew internal pA/pT search,
    config.xml:97-105 (internalpATlength/internalFractionATInPolyAT).
    """
    B, L = seqs.shape
    if L < k:
        return (jnp.zeros((B,), jnp.int32),
                jnp.full((B, max_sites), -1, jnp.int32))
    ind = (seqs == base).astype(jnp.int32)
    counts = scan._rolling_count(ind, k)
    npos = L - k + 1
    pos = jnp.arange(npos, dtype=jnp.int32)[None, :]
    inread = pos <= (lens[:, None] - k)
    internal = (pos >= edge) & ((pos + k - 1) < (lens[:, None] - edge))
    ok = (counts >= min_count) & inread & internal

    starts = []
    for _ in range(max_sites):
        j = jnp.min(jnp.where(ok, pos, BIG), axis=1)  # first passing window
        found = j < BIG
        starts.append(jnp.where(found, j, -1).astype(jnp.int32))
        # mask the contiguous run starting at j (conservatively [j, j + 2k))
        mask = (pos >= j[:, None]) & (pos < (j[:, None] + 2 * k))
        ok = ok & ~mask
    st = jnp.stack(starts, axis=1)
    return jnp.sum(st >= 0, axis=1).astype(jnp.int32), st


def pack_nibbles_np(codes: np.ndarray) -> np.ndarray:
    """[B, 2E] int8 codes (0..5) -> [B, E] uint8, two 4-bit codes per byte.

    Halves the host->device bytes of the byte-code layout."""
    c = codes.astype(np.uint8)
    return (c[:, 0::2] << 4) | c[:, 1::2]


def unpack_nibbles(packed: jax.Array) -> jax.Array:
    """Device-side inverse of pack_nibbles_np: [B, E] uint8 -> [B, 2E] int8."""
    B, E = packed.shape
    hi = (packed >> 4).astype(jnp.int8)
    lo = (packed & jnp.uint8(0xF)).astype(jnp.int8)
    return jnp.stack([hi, lo], axis=-1).reshape(B, 2 * E)


def make_edge_scan_fn(cfg: PipelineConfig):
    """Build the jitted edge-scan function (fixed [B, 2*EDGE] shape).

    Returns scan_fn(seqs, lens, peq_ad, peq_adc, peq_tso) -> dict of
    position/ED results (QVs are host-side — quals never ship to device).
    peq_* are [4, 1] uint32 single-pattern bitmasks (adapter short form,
    adapter complete, TSO) in SENSE orientation. `lens` are composite
    lengths (min(true_len, 2*EDGE)).
    """
    p = cfg.polyat
    is5p = getattr(cfg, "chemistry", "3p") == "5p"
    a = cfg.adapter5p if is5p else cfg.adapter3p
    t = cfg.tso5p if is5p else cfg.tso3p
    bc_len = cfg.barcodes.cell_bc_length
    pad = cfg.readscanner.test_plus_minus_pos
    k = p.polyat_length
    min_count = scan.min_count_for(k, p.fraction_at_in_polyat)
    awin = a.adapter_search_window
    twin = t.window_for_tso_search
    m_ad = len(a.sequence)
    m_adc = len(a.sequence_complete)
    m_tso = len(t.sequence)
    bc_win = bc_len + 2 * pad + 2  # slack for deletions in the adapter match
    nbases = cfg.readscanner.nbases_of_adapter_seq_in_readname
    x_len = 40 + nbases  # X= spans [AE-40, AE+nbases-1] (README example: 43)

    @jax.jit
    def scan_fn(seqs, lens, peq_ad, peq_adc, peq_tso):
        B, L = seqs.shape

        # ---- polyA (3' end, FWD hypothesis) / polyT (5' start, REV) ----
        fwd_found, fwd_ps, fwd_pe = scan.polyat_find(
            seqs, lens, base=dna.A, k=k, min_count=min_count,
            window=p.window_search_for_polya, from_end=True)
        rev_found, rev_ts, rev_te = scan.polyat_find(
            seqs, lens, base=dna.T, k=k, min_count=min_count,
            window=p.window_search_for_polya, from_end=False)

        # ---- adapter search, unified sense-orientation window ----
        if is5p:
            # 5' chemistry: adapter-BC-UMI-TSO at the stranded 5' START
            # (config.xml:120-134). FWD: read head as-is; REV: rc of the
            # read tail — both windows carry adapter+BC in sense orientation
            # at stranded offset 0.
            w_fwd = gather_window(seqs, lens, jnp.zeros_like(lens), awin)
            w_rev = gather_window(seqs, lens, lens - awin, awin, rc=True)
        else:
            # 3' chemistry. FWD: rc window after polyA end ->
            # [rc(tail) adapter BC UMI]
            w_fwd = gather_window(seqs, lens, fwd_pe + 1, awin, rc=True)
            # REV: window before polyT start -> [head adapter BC UMI]
            w_rev = gather_window(seqs, lens, rev_ts - awin, awin, rc=False)
        # one stacked sweep for both hypotheses
        ed2, pos2 = scan.adapter_search(
            jnp.concatenate([w_fwd, w_rev], axis=0), peq_ad, m_ad)
        ed_f, ed_r = ed2[:B], ed2[B:]
        pos_f, pos_r = pos2[:B], pos2[B:]
        ed_f = jnp.where(fwd_found, ed_f, BIG)
        ed_r = jnp.where(rev_found, ed_r, BIG)

        # strand choice: hypothesis whose adapter matched within budget wins;
        # both pass -> lower adapter ED, tie -> FWD (policy; jar internals
        # are unobservable, see module docstring)
        ok_f = fwd_found & (ed_f <= a.max_needleman_mismatches)
        ok_r = rev_found & (ed_r <= a.max_needleman_mismatches)
        is_fwd = ok_f & (~ok_r | (ed_f <= ed_r))
        stranded = ok_f | ok_r
        is_fwd = jnp.where(stranded, is_fwd, fwd_found)

        # stranded-coordinate results (composite coords; host remaps)
        ps = jnp.where(is_fwd, fwd_ps, lens - 1 - rev_te)
        pe = jnp.where(is_fwd, fwd_pe, lens - 1 - rev_ts)
        has_pat = jnp.where(is_fwd, fwd_found, rev_found)
        ps = jnp.where(has_pat, ps, -1)
        pe = jnp.where(has_pat, pe, -1)

        # AE: last adapter base before the BC, stranded coords.
        if is5p:
            # both 5p windows start at stranded offset 0 in sense
            # orientation: AE = match end position directly
            ae = jnp.where(is_fwd, pos_f, pos_r)
        else:
            # FWD window w' maps w'[i] <- read[pe + awin - i]; adapter match
            # end at i_e -> AE = pe + awin - i_e (first rcAdapter base in
            # read). REV window starts at rev_ts - awin; stranded pos of
            # orig q is len-1-q -> AE = len-1-(rev_ts-awin+i_e).
            ae = jnp.where(is_fwd, fwd_pe + awin - pos_f,
                           lens - 1 - (rev_ts - awin + pos_r))
        ad_ed = jnp.where(is_fwd, ed_f, ed_r)
        ad_pos_local = jnp.where(is_fwd, pos_f, pos_r)
        ae = jnp.where(stranded, ae, -1)

        # complete-adapter ED in the same window (pass-1 stringency + stats)
        w_used = jnp.where(is_fwd[:, None], w_fwd, w_rev)
        edc, _ = scan.adapter_search(w_used, peq_adc, m_adc)

        # consecutive-match runs of the complete adapter (pass-1 filter:
        # minAdapter3pMatches consecutive matches, config.xml:60-61)
        ad_runs, _ = scan.match_run_stats(
            w_used, jnp.asarray(dna.encode(a.sequence_complete)), m_adc)

        # ---- BC window (sense orientation) right after the adapter end ----
        bc_start_local = ad_pos_local + 1 - pad
        bc_windows = gather_window(w_used, jnp.full((B,), awin, jnp.int32),
                                   bc_start_local, bc_win, rc=False)

        # ---- TSO search ----
        # 3p: stranded 5' start window; 5p: after adapter+BC (UMI then TSO,
        # config.xml:174-176 "the sequence after the UMI, just before cDNA")
        t0 = (ae + 1 + bc_len) if is5p else jnp.zeros_like(lens)
        w5_f = gather_window(seqs, lens, t0, twin)
        w5_r = gather_window(seqs, lens, lens - twin - t0, twin, rc=True)
        w5 = jnp.where(is_fwd[:, None], w5_f, w5_r)
        tso_ed, tso_pos = scan.adapter_search(w5, peq_tso, m_tso)
        # consecutive-match bailouts (config.xml:160-166; see
        # ops.scan.run_bailout)
        bail = scan.run_bailout(
            w5, jnp.asarray(dna.encode(t.sequence)), m_tso,
            t.min_tso_consecutive_matches,
            t.min_tso_two_best_consecutive_matches)
        tso_found = (tso_ed <= t.max_needleman_mismatches) | bail
        tso_end = jnp.where(tso_found,
                            t0 + tso_pos + (t.offset_tso_end - 1), -1)

        # X region: 3p stranded [ae - 40, ae + nbases - 1];
        # 5p [ae - nbases + 1, ae + 40] (adapter tail + BC + UMI + TSO head)
        if is5p:
            xs_str = ae - nbases + 1
            xe_str = ae + (x_len - nbases)
        else:
            xs_str = ae - (x_len - nbases)
            xe_str = ae + nbases - 1

        return {
            "is_fwd": is_fwd, "stranded": stranded, "has_polyat": has_pat,
            "ps": ps, "pe": pe, "ae": ae,
            "adapter_ed": jnp.where(stranded, ad_ed, BIG),
            "adapter_complete_ed": edc,
            "adapter_run": ad_runs,
            "bc_windows": bc_windows,
            "tso_end": tso_end, "tso_ed": tso_ed,
            "x_start": xs_str, "x_end": xe_str,
        }

    return scan_fn


# Edge-scan meta rows pack into ONE int16 matrix so a device fetch is one
# small transfer, not 14. All values are composite coords (< 2*EDGE) or
# small EDs; BIG sentinels clamp to I16_BIG.
EDGE_META_KEYS = (
    "is_fwd", "stranded", "has_polyat", "ps", "pe", "ae", "adapter_ed",
    "adapter_complete_ed", "adapter_run", "tso_end", "tso_ed",
    "x_start", "x_end")
_BOOL_KEYS = {"is_fwd", "stranded", "has_polyat"}
I16_BIG = 32000


def _pack_meta(out: dict, keys=EDGE_META_KEYS) -> jax.Array:
    rows = [jnp.clip(out[k].astype(jnp.int32), -I16_BIG, I16_BIG)
            .astype(jnp.int16) for k in keys]
    return jnp.stack(rows, axis=0)


def make_edge_scan_packed_fn(cfg: PipelineConfig):
    """Packed variant: (packed_seq [B, EDGE] uint8 nibbles, lens, peq*) ->
    (meta [len(EDGE_META_KEYS), B] int16, bc_windows [B, W] int8)."""
    body = make_edge_scan_fn(cfg)

    @jax.jit
    def packed(packed_seq, lens, peq_ad, peq_adc, peq_tso):
        out = body(unpack_nibbles(packed_seq), lens, peq_ad, peq_adc, peq_tso)
        return _pack_meta(out), out["bc_windows"]

    return packed


def unpack_edge_meta(meta: np.ndarray, keys=EDGE_META_KEYS) -> dict:
    """Host-side inverse of _pack_meta (adds nothing qual-derived)."""
    out = {}
    for r, k in enumerate(keys):
        v = meta[r].astype(np.int32)
        if k in _BOOL_KEYS:
            v = v.astype(bool)
        out[k] = v
    if "adapter_ed" in out:
        out["adapter_ed"] = np.where(out["adapter_ed"] >= I16_BIG, BIG,
                                     out["adapter_ed"])
    return out


def compute_qvs_np(qv: np.ndarray, lens: np.ndarray, out: dict,
                   bc_len: int, is5p: bool = False,
                   qsum: np.ndarray | None = None) -> None:
    """Host-side QV means (read/X-region/BC-region); adds read_qv/x_qv/
    bc_qv to `out`.

    Windows are narrow (X region ~43 nt, BC 16 nt) so each mean is a
    bounded [B, W] gather + masked row-sum — O(B*W) instead of the full
    [B, L] prefix-sum, whose 250 MB scan was a top host term of the pass-2
    budget. `qsum` (per-read qual sums, free from the native encode pass)
    skips the whole-matrix row sum too."""
    B, L = qv.shape
    lens = np.asarray(lens).astype(np.int64)
    if qsum is None:
        qsum = qv.sum(axis=1, dtype=np.int32)
    out["read_qv"] = (qsum / np.maximum(lens, 1)).astype(np.float32)
    is_fwd = out["is_fwd"]
    ae = out["ae"]
    rows = np.arange(B)[:, None]
    want_x = "x_start" in out

    def window_mean(s_str, e_str):
        s = np.where(is_fwd, s_str, lens - 1 - e_str)
        e = np.where(is_fwd, e_str, lens - 1 - s_str)
        s = np.clip(s, 0, L)
        e1 = np.minimum(np.clip(e + 1, 0, L), lens)
        n = np.maximum(e1 - s, 1)
        Wm = max(int(np.max(n, initial=1)), 1)
        cols = s[:, None] + np.arange(Wm, dtype=np.int64)
        m = cols < e1[:, None]
        w = qv[rows, np.minimum(cols, L - 1)].astype(np.int32)
        return ((w * m).sum(axis=1) / n).astype(np.float32)

    if want_x:
        out["x_qv"] = window_mean(out["x_start"], out["x_end"])
    if is5p:  # BC right AFTER the adapter end in 5' chemistry
        out["bc_qv"] = window_mean(ae + 1, ae + bc_len)
    else:
        out["bc_qv"] = window_mean(ae - bc_len, ae - 1)


def make_internal_scan_fn(cfg: PipelineConfig, max_sites: int = 4):
    """Build the jitted internal/chimera scan (bucketed full-length shapes).

    Returns fn(seqs, lens, peq_adc) -> dict with per-site confirmation EDs
    and split positions (part 2 starts at split). Reference:
    ChimeraFindernew (`$SplitPosition$SplitReason`), README.md:90-91,452-457.
    """
    p = cfg.polyat
    m_adc = len(cfg.adapter3p.sequence_complete)
    k = p.internal_pat_length
    mc = scan.min_count_for(k, p.internal_fraction_at_in_polyat)
    edge = p.window_search_for_polya
    Wi = 160  # covers polyA run tail + UMI + BC + complete adapter

    @jax.jit
    def fn(seqs, lens, peq_adc):
        B, L = seqs.shape
        nA, sA = internal_sites(seqs, lens, base=dna.A, k=k, min_count=mc,
                                edge=edge, max_sites=max_sites)
        nT, sT = internal_sites(seqs, lens, base=dna.T, k=k, min_count=mc,
                                edge=edge, max_sites=max_sites)
        K = max_sites
        rs = jnp.repeat(seqs, K, axis=0)
        rl = jnp.repeat(lens, K)
        # A-junction: ...cDNA1 polyA rcUMI rcBC rcAdapterC | cDNA2...
        # confirm complete adapter (sense) in the rc window after run start.
        a_wins = gather_window(rs, rl, sA.reshape(-1), Wi, rc=True)
        a_ed, a_pos = scan.adapter_search(a_wins, peq_adc, m_adc)
        a_ed = jnp.where(sA.reshape(-1) >= 0, a_ed, BIG).reshape(B, K)
        # rc window w' of [s, s+Wi): w'[i] <-> read[s+Wi-1-i]; adapter sense
        # end i_e -> orig first rcAdapterC base = s+Wi-1-i_e; cassette ends
        # m_adc-1 later; part 2 starts after it.
        a_split = (sA.reshape(-1) + Wi - 1 - a_pos + (m_adc - 1) + 1).reshape(B, K)
        # T-junction: ...rc(cDNA1) | adapterC BC UMI polyT cDNA2... confirm
        # complete adapter (sense) right before the polyT run.
        t_wins = gather_window(rs, rl, sT.reshape(-1) - Wi, Wi, rc=False)
        t_ed, t_pos = scan.adapter_search(t_wins, peq_adc, m_adc)
        t_ed = jnp.where(sT.reshape(-1) >= 0, t_ed, BIG).reshape(B, K)
        # adapter end at orig (sT-Wi)+i_e; cassette starts m_adc-1 earlier.
        t_split = (sT.reshape(-1) - Wi + t_pos - (m_adc - 1)).reshape(B, K)
        # pack into one int32 matrix (single d2h transfer; see EDGE_META_KEYS)
        return jnp.concatenate([
            nA[None, :], sA.T, a_ed.T, a_split.T,
            nT[None, :], sT.T, t_ed.T, t_split.T], axis=0)

    return fn


# ---------------------------------------------------------------------------
# Tiled internal/chimera scan (pass-2 hot path)
# ---------------------------------------------------------------------------
#
# The bucketed full-length scan_internal above re-encodes every long read at
# its full padded length and round-trips the device synchronously per length
# bucket — measured ~70% of warm pass-2 wall-clock. The pipeline instead
# cuts read INTERIORS into fixed [TILE]-base tiles with enough context on
# both sides for the confirm windows, so the whole chunk is one fixed-shape
# async dispatch regardless of the read-length distribution.
#
# Semantics vs scan_internal (reference ChimeraFindernew): detection marks
# polyA/T RUN STARTS (first passing window of each maximal passing stretch)
# instead of greedy 2k-spaced windows — a long homopolymer run yields one
# candidate instead of several duplicates whose identical split positions
# the old path double-counted into spurious MULTI_CHIMERIC discards; exact
# duplicate split positions are deduplicated. A run crossing a tile
# ownership boundary may surface in both tiles; those duplicates collapse
# the same way (their confirmed split position is identical).

TILE = 1024         # bases per internal-scan tile
TILE_CTX = 192      # ownership context: >= confirm window (160) + run slack
TILE_STRIDE = TILE - 2 * TILE_CTX
TILE_META = 16      # appended meta bytes per tile row
K_TILE_SITES = 3    # captured run starts per direction per tile
WI_CONFIRM = 160    # confirm window length (polyA run + UMI + BC + adapter)


def build_tiles(seqs: list[bytes], cfg: PipelineConfig):
    """Cut long-read interiors into TILE-base tiles.

    Returns (rows [T, TILE/2 + TILE_META] uint8 — nibble codes plus meta
    (own_lo u16, own_hi u16, tlen u16, pad, g0 u32, rlen u32) — read_idx
    [T] int32, g0s [T] int32); T == 0 when no read qualifies."""
    from sicelore_tpu.io import native as _native

    p = cfg.polyat
    edge = p.window_search_for_polya
    k = p.internal_pat_length
    ext = _native.get_hostenc()
    if ext is not None and hasattr(ext, "encode_tiles"):
        rows_b, ri_b, g0_b = ext.encode_tiles(seqs, edge, k, TILE, TILE_CTX)
        rows = np.frombuffer(rows_b, np.uint8).reshape(
            -1, TILE // 2 + TILE_META)
        return (rows, np.frombuffer(ri_b, np.int32),
                np.frombuffer(g0_b, np.int32))
    min_len = 2 * edge + k
    tiles: list[bytes] = []
    read_idx: list[int] = []
    meta: list[tuple] = []
    for i, sq in enumerate(seqs):
        L = len(sq)
        if L <= min_len:
            continue
        lo_g, hi_g = edge, L - edge - k + 1
        if hi_g <= lo_g:
            continue
        t = 0
        while True:
            own_start = 0 if t == 0 else t * TILE_STRIDE + TILE_CTX
            if own_start >= hi_g:
                break
            g0 = t * TILE_STRIDE
            own_end = TILE_CTX + (t + 1) * TILE_STRIDE
            ol, oh = max(own_start, lo_g), min(own_end, hi_g)
            if ol < oh:
                tiles.append(sq[g0:g0 + TILE])
                read_idx.append(i)
                meta.append((ol - g0, oh - g0, min(TILE, L - g0), g0, L))
            t += 1
    T = len(tiles)
    if T == 0:
        return (np.zeros((0, TILE // 2 + TILE_META), np.uint8),
                np.zeros(0, np.int32), np.zeros(0, np.int32))
    ext = _native.get_hostenc()
    if ext is not None:
        codes_b, _ = ext.encode_batch(tiles, TILE, int(dna.PAD))
        codes = np.frombuffer(codes_b, np.int8).reshape(T, TILE)
    else:
        codes, _ = dna.encode_batch(tiles, TILE)
    rows = np.zeros((T, TILE // 2 + TILE_META), np.uint8)
    rows[:, :TILE // 2] = pack_nibbles_np(codes)
    ma = np.asarray(meta, np.int64)
    mv = rows[:, TILE // 2:]
    mv[:, 0] = ma[:, 0] & 0xFF
    mv[:, 1] = ma[:, 0] >> 8
    mv[:, 2] = ma[:, 1] & 0xFF
    mv[:, 3] = ma[:, 1] >> 8
    mv[:, 4] = ma[:, 2] & 0xFF
    mv[:, 5] = ma[:, 2] >> 8
    mv[:, 8:12] = (ma[:, 3].astype("<u4").view(np.uint8).reshape(-1, 4))
    mv[:, 12:16] = (ma[:, 4].astype("<u4").view(np.uint8).reshape(-1, 4))
    return rows, np.asarray(read_idx, np.int32), ma[:, 3].astype(np.int32)


def _make_internal_tile_inner(cfg: PipelineConfig):
    p = cfg.polyat
    k = p.internal_pat_length
    mc = scan.min_count_for(k, p.internal_fraction_at_in_polyat)
    m_adc = len(cfg.adapter3p.sequence_complete)
    edmax = cfg.adapter3p.max_complete_seq_needleman_mismatches
    Wi = WI_CONFIRM
    K = K_TILE_SITES

    def inner(rows, peq_adc):
        S = rows.shape[0]
        codes = unpack_nibbles(rows[:, :TILE // 2])
        mb = rows[:, TILE // 2:].astype(jnp.int32)
        own_lo = mb[:, 0] | (mb[:, 1] << 8)
        own_hi = mb[:, 2] | (mb[:, 3] << 8)
        tlen = mb[:, 4] | (mb[:, 5] << 8)
        g0 = (mb[:, 8] | (mb[:, 9] << 8) | (mb[:, 10] << 16)
              | (mb[:, 11] << 24))
        rlen = (mb[:, 12] | (mb[:, 13] << 8) | (mb[:, 14] << 16)
                | (mb[:, 15] << 24))
        npos = TILE - k + 1
        pos = jnp.arange(npos, dtype=jnp.int32)[None, :]
        site_lists = []
        for base in (dna.A, dna.T):
            ind = (codes == base).astype(jnp.int32)
            counts = scan._rolling_count(ind, k)
            ok = ((counts >= mc) & (pos >= own_lo[:, None])
                  & (pos < own_hi[:, None]) & (pos <= tlen[:, None] - k))
            rs = ok & ~jnp.pad(ok[:, :-1], ((0, 0), (1, 0)))
            ss = []
            for _ in range(K):
                j = jnp.min(jnp.where(rs, pos, BIG), axis=1)
                ss.append(jnp.where(j < BIG, j, -1).astype(jnp.int32))
                rs = rs & (pos > j[:, None])
            site_lists.append(jnp.stack(ss, axis=1))     # [S, K]
        sA, sT = site_lists
        # confirm both directions in ONE stacked adapter sweep
        rs6 = jnp.tile(jnp.repeat(codes, K, axis=0), (2, 1))
        rl6 = jnp.tile(jnp.repeat(tlen, K), 2)
        starts = jnp.concatenate([sA.reshape(-1),
                                  sT.reshape(-1) - Wi])
        rc6 = jnp.concatenate([jnp.ones(S * K, bool),
                               jnp.zeros(S * K, bool)])
        wins = gather_window(rs6, rl6, starts, Wi)
        comp = jnp.asarray(dna._COMP, dtype=jnp.int8)
        wins = jnp.where(rc6[:, None], comp[wins][:, ::-1], wins)
        ed6, pos6 = scan.adapter_search(wins, peq_adc, m_adc)
        a_ed = ed6[:S * K].reshape(S, K)
        a_pos = pos6[:S * K].reshape(S, K)
        t_ed = ed6[S * K:].reshape(S, K)
        t_pos = pos6[S * K:].reshape(S, K)
        # A-junction: rc window w'[i] <-> read[s+Wi-1-i]; adapter end i_e ->
        # cassette ends m_adc-1 later; part 2 starts after it
        a_split = sA + Wi - 1 - a_pos + m_adc
        # T-junction: adapter end at (s-Wi)+i_e; cassette starts m_adc-1
        # earlier
        t_split = sT - Wi + t_pos - (m_adc - 1)
        spl = jnp.concatenate([a_split, t_split], axis=1)  # [S, 2K]
        okc = jnp.concatenate(
            [(sA >= 0) & (a_ed <= edmax), (sT >= 0) & (t_ed <= edmax)],
            axis=1)
        gpos = g0[:, None] + spl
        okc = okc & (gpos > 50) & (gpos < rlen[:, None] - 50)
        # distinct confirmed splits; first two (tile-local coords)
        n = jnp.zeros(S, jnp.int32)
        s0 = jnp.full(S, -1, jnp.int32)
        s1 = jnp.full(S, -1, jnp.int32)
        seen = []
        for i2 in range(2 * K):
            dup = jnp.zeros(S, bool)
            for j2, okj in seen:
                dup = dup | (okj & (spl[:, j2] == spl[:, i2]))
            take = okc[:, i2] & ~dup
            s0 = jnp.where(take & (n == 0), spl[:, i2], s0)
            s1 = jnp.where(take & (n == 1), spl[:, i2], s1)
            n = n + take.astype(jnp.int32)
            seen.append((i2, okc[:, i2] & ~dup))
        return jnp.stack([n, s0, s1], axis=0).astype(jnp.int16)

    return inner


def make_internal_tile_map_fn(cfg: PipelineConfig):
    """lax.map mega dispatcher over [C, S, TILE/2+16] tile-row stacks."""
    inner = _make_internal_tile_inner(cfg)

    @jax.jit
    def mega(rows3, peq_adc):
        return jax.lax.map(lambda r: inner(r, peq_adc), rows3)

    return mega


def make_internal_tile_sharded_fn(cfg: PipelineConfig, mesh,
                                  data_axis: str = "data"):
    """Multi-chip tile scan: slice stacks data-parallel over `data_axis`
    (per-tile results need no collective)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    inner = _make_internal_tile_inner(cfg)

    def local(rows3, peq_adc):
        return jax.lax.map(lambda r: inner(r, peq_adc), rows3)

    sharded = jax.shard_map(local, mesh=mesh, in_specs=(P(data_axis), P()),
                            out_specs=P(data_axis), check_vma=False)
    return jax.jit(sharded, in_shardings=(
        NamedSharding(mesh, P(data_axis)), NamedSharding(mesh, P())))


def unpack_internal_meta(meta: np.ndarray, max_sites: int = 4) -> dict:
    K = max_sites
    rows = {}
    off = 0
    for name, n in (("n_internal_a", 1), ("internal_a", K),
                    ("internal_a_ed", K), ("internal_a_split", K),
                    ("n_internal_t", 1), ("internal_t", K),
                    ("internal_t_ed", K), ("internal_t_split", K)):
        v = meta[off:off + n]
        rows[name] = v[0] if n == 1 else v.T
        off += n
    return rows


# ---------------------------------------------------------------------------
# Composite (edge-splice) encoding
# ---------------------------------------------------------------------------

_ENC_PAD0 = dna._ENC.copy()
_ENC_PAD0[0] = dna.PAD  # NUL byte = padding in the bulk-encode fast path


def _hostenc():
    """Native encode extension (native/hostenc) or None -> numpy fallback."""
    from sicelore_tpu.io import native
    return native.get_hostenc()


def encode_composite(seqs: list[bytes], quals: list[bytes], edge: int = EDGE):
    """Encode reads into fixed [B, 2*edge] composites (head + tail splice).

    Reads longer than 2*edge keep their first and last `edge` bases; all
    stranding evidence lives there (polyA window 150 + adapter window 110).
    Returns (codes, qv, comp_lens, true_lens). Bulk path: one bytes join +
    one table lookup (the per-read numpy loop was the pass-2 host
    bottleneck at ~13us/read)."""
    B, W = len(seqs), 2 * edge
    true_lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=B)
    comp_lens = np.minimum(true_lens, W)
    z = b"\x00"
    sbuf = b"".join(
        s[:edge].ljust(edge, z)
        + (s[edge:W] if len(s) <= W else s[-edge:]).ljust(edge, z)
        for s in seqs)
    codes = _ENC_PAD0[np.frombuffer(sbuf, np.uint8)].reshape(B, W)
    qbuf = b"".join(
        q[:edge].ljust(edge, z)
        + (q[edge:W] if len(q) <= W else q[-edge:]).ljust(edge, z)
        for q in quals)
    qarr = np.frombuffer(qbuf, np.uint8).reshape(B, W)
    qv = np.where(qarr >= 33, qarr.astype(np.int16) - 33, 0).astype(np.int8)
    return codes, qv, comp_lens, true_lens


def remap_composite(pos: np.ndarray, true_lens: np.ndarray,
                    edge: int = EDGE) -> np.ndarray:
    """Map composite stranded coords back to true read coords.

    For reads longer than 2*edge, composite positions >= edge belong to the
    read tail: true = pos + (true_len - 2*edge). Negative positions pass
    through (not-found sentinels).
    """
    W = 2 * edge
    shift = np.maximum(true_lens - W, 0)
    out = np.where((pos >= edge), pos + shift, pos)
    return np.where(pos < 0, pos, out)


def pack_2bit_np(codes: np.ndarray) -> np.ndarray:
    """[B, 4E] int8 codes -> [B, E] uint8, four 2-bit bases per byte.

    Non-ACGT codes are clamped to T; callers must route reads containing N
    through the 4-bit path (encode_composite_2bit returns the dirty mask).
    Positions beyond the composite length may hold garbage — every device
    consumer masks by `lens`."""
    c = np.minimum(codes, 3).astype(np.uint8)
    return ((c[:, 0::4] << 6) | (c[:, 1::4] << 4)
            | (c[:, 2::4] << 2) | c[:, 3::4])


def unpack_2bit(packed: jax.Array) -> jax.Array:
    """Device-side inverse of pack_2bit_np: [B, E] uint8 -> [B, 4E] int8."""
    B, E = packed.shape
    parts = [((packed >> s) & jnp.uint8(3)).astype(jnp.int8)
             for s in (6, 4, 2, 0)]
    return jnp.stack(parts, axis=-1).reshape(B, 4 * E)


def encode_composite_2bit(seqs: list[bytes], quals: list[bytes],
                          edge: int = EDGE):
    """2-bit composite encoding — halves the nibble path's host->device
    bytes again.

    Returns (packed [B, edge/2] uint8, qv, comp_lens, true_lens,
    dirty [B] bool). `dirty` marks reads with a non-ACGT base inside the
    composite; those must run through the 4-bit fallback (2 bits cannot
    represent N, and N must never match — reference NW scoring treats it
    as mismatch)."""
    ext = _hostenc()
    if ext is not None:
        B, W = len(seqs), 2 * edge
        p, q, cl, tl, dr, qs = ext.encode_composite_2bit(seqs, quals, edge)
        packed = np.frombuffer(p, np.uint8).reshape(B, edge // 2)
        qv = np.frombuffer(q, np.int8).reshape(B, W)
        comp_lens = np.frombuffer(cl, np.int32)
        true_lens = np.frombuffer(tl, np.int32)
        dirty = np.frombuffer(dr, np.uint8).astype(bool)
        qsum = np.frombuffer(qs, np.int32)
        return packed, qv, comp_lens, true_lens, dirty, qsum
    codes, qv, comp_lens, true_lens = encode_composite(seqs, quals, edge)
    B, W = codes.shape
    cols = np.arange(W, dtype=np.int32)[None, :]
    dirty = ((codes == dna.N_CODE) & (cols < comp_lens[:, None])).any(axis=1)
    return (pack_2bit_np(codes), qv, comp_lens, true_lens, dirty,
            qv.sum(axis=1, dtype=np.int32))


SEARCH_ROWS = 5  # best_ed, idx_lo, idx_hi, second_ed, overflow


# ---------------------------------------------------------------------------
# v2: two-half text-major scan (ops.edgescan)
# ---------------------------------------------------------------------------
#
# The production path. The composite ships TEXT-MAJOR 2-bit packed
# ([PACK_ROWS, B] u8); the edge scan's BC-window rows feed the whitelist
# sweep text-major (no transposes), and the downloaded int16 rows carry
# HALF-LOCAL coordinates finalized on the host (edgescan.finalize_meta_np)
# — no remap pass, int16-safe for any length.

from sicelore_tpu.ops import edgescan as eg2  # noqa: E402

# downloaded row sets: boolean/small rows bit-pack into one FLAGS row per
# pass, so each read downloads a few int16 rows:
#   pass-2 flags: is_fwd | stranded<<1 | has_polyat<<2 | overflow<<3
#                 | idx_hi<<4        (idx_hi = best_idx >> 16, < 1024)
#   pass-1 flags: is_fwd | stranded<<1 | has_polyat<<2 | kmer_valid<<3
#                 | adapter_run<<4   (run <= pattern length 31)
P2_META_ROWS = (eg2.ROW_PS, eg2.ROW_PE, eg2.ROW_AE, eg2.ROW_TSO_END)
P2_ROW_NAMES = ("flags", "ps", "pe", "ae", "tso_end",
                "best_ed", "idx_lo", "second_ed")
P1_META_ROWS = (eg2.ROW_AE, eg2.ROW_KMER_LO, eg2.ROW_KMER_HI)
P1_ROW_NAMES = ("flags", "ae", "kmer_lo", "kmer_hi")


def _unpack_flag_rows(arr: np.ndarray, names) -> dict:
    """[R, B] i16 -> named int64 rows with the flags row expanded."""
    rows = {n: arr[i].astype(np.int64) for i, n in enumerate(names)}
    fl = rows.pop("flags")
    rows["is_fwd"] = fl & 1
    rows["stranded"] = (fl >> 1) & 1
    rows["has_polyat"] = (fl >> 2) & 1
    if "best_ed" in rows:      # pass-2 layout
        rows["overflow"] = (fl >> 3) & 1
        rows["idx_hi"] = (fl >> 4) & 0x3FF
    else:                      # pass-1 layout
        rows["kmer_valid"] = (fl >> 3) & 1
        rows["adapter_run"] = (fl >> 4) & 0x3F
    return rows


def finalize_rows_np(arr: np.ndarray, names, true_lens: np.ndarray,
                     cfg: PipelineConfig) -> dict:
    """Host finalization of a downloaded int16 row subset: half-local
    coordinates -> true stranded coords (see edgescan.finalize_meta_np)."""
    rows = _unpack_flag_rows(arr, names)
    L = np.asarray(true_lens).astype(np.int64)
    is_fwd = rows["is_fwd"] != 0
    stranded = rows["stranded"] != 0
    out = {"is_fwd": is_fwd, "stranded": stranded,
           "true_lens": np.asarray(true_lens)}
    if "has_polyat" in rows:
        out["has_polyat"] = rows["has_polyat"] != 0
    shift = L - eg2.E
    is5p = getattr(cfg, "chemistry", "3p") == "5p"

    def fin(loc):
        return np.where(is_fwd, loc + shift, L - 1 - loc)

    if "ps" in rows:
        has_pat = out["has_polyat"]
        out["ps"] = np.where(has_pat, fin(rows["ps"]), -1)
        out["pe"] = np.where(has_pat, fin(rows["pe"]), -1)
    if "ae" in rows:
        ae = np.where(stranded,
                      rows["ae"] if is5p else fin(rows["ae"]), -1)
        out["ae"] = ae
        nb = cfg.readscanner.nbases_of_adapter_seq_in_readname
        if is5p:
            out["x_start"] = ae - nb + 1
            out["x_end"] = ae + 40
        else:
            out["x_start"] = ae - 40
            out["x_end"] = ae + nb - 1
    if "tso_end" in rows:
        out["tso_end"] = rows["tso_end"]
    if "adapter_run" in rows:
        out["adapter_run"] = rows["adapter_run"]
    if "kmer_lo" in rows:
        out["bc_kmer"] = (((rows["kmer_hi"] & 0xFFFF) << 16)
                          | (rows["kmer_lo"] & 0xFFFF)).astype(np.uint32)
        out["bc_kmer_valid"] = rows["kmer_valid"] != 0
    for k in ("best_ed", "idx_lo", "idx_hi", "second_ed", "overflow"):
        if k in rows:
            out[k] = rows[k]
    return out


SEARCH_MODES = ("sweep", "prefilter")


def _search_rows(mode: str, wins_tm, peq_bc, nvalid, qgram_t, m: int,
                 radius: int, K: int):
    """Whitelist search over text-major BC windows [bw, S] -> ([4, S]
    best_ed, best_idx, second_ed, end_pos; overflow [S])."""
    from sicelore_tpu.ops import bcsearch

    if mode == "prefilter":
        res = bcsearch.qgram_prefilter_search(
            jnp.transpose(wins_tm).astype(jnp.int8), qgram_t, peq_bc,
            nvalid, m, radius, K)
        return res[:4], res[4]
    best = bcsearch.sweep_top2(wins_tm.astype(jnp.int32), peq_bc, nvalid, m)
    return best, jnp.zeros_like(best[0])


def make_scan_search2_body(cfg: PipelineConfig, mode: str, radius: int = 2,
                           K: int = 64):
    """v2 fused edge scan + whitelist search over the text-major packed
    composite. fn(packed_tm [PACK_ROWS, S] u8, peq_ad, peq_adc, peq_tso,
    peq_bc, nvalid, qgram_t) -> int16 [len(P2_ROWS) + SEARCH_ROWS, S]."""
    body = eg2.make_edge_scan2_packed(cfg)
    m = cfg.barcodes.cell_bc_length
    bw = eg2.bc_window_width(cfg)

    def fn(packed_tm, peq_ad, peq_adc, peq_tso, peq_bc, nvalid, qgram_t):
        meta = body(packed_tm, peq_ad, peq_adc, peq_tso)
        wins_tm = meta[eg2.ROW_BC0:eg2.ROW_BC0 + bw]          # [bw, S] i32
        best, overflow = _search_rows(mode, wins_tm, peq_bc, nvalid,
                                      qgram_t, m, radius, K)
        flags = (meta[eg2.ROW_IS_FWD]
                 | (meta[eg2.ROW_STRANDED] << 1)
                 | (meta[eg2.ROW_HAS_POLYAT] << 2)
                 | (jnp.minimum(overflow, 1) << 3)
                 | ((best[1] >> 16) << 4))
        rows16 = jnp.stack(
            [flags]
            + [jnp.clip(meta[r], -I16_BIG, I16_BIG) for r in P2_META_ROWS]
            + [jnp.clip(best[0], -I16_BIG, I16_BIG),
               best[1] & 0xFFFF,
               jnp.clip(best[2], -I16_BIG, I16_BIG)],
            axis=0).astype(jnp.int16)
        return rows16

    return fn


def make_pass1_body2(cfg: PipelineConfig):
    """v2 pass-1 body: fn(packed_tm, peq_ad, peq_adc, peq_tso) -> int16
    [len(P1_ROWS), S]."""
    body = eg2.make_edge_scan2_packed(cfg)

    def fn(packed_tm, peq_ad, peq_adc, peq_tso):
        meta = body(packed_tm, peq_ad, peq_adc, peq_tso)
        flags = (meta[eg2.ROW_IS_FWD]
                 | (meta[eg2.ROW_STRANDED] << 1)
                 | (meta[eg2.ROW_HAS_POLYAT] << 2)
                 | (meta[eg2.ROW_KMER_VALID] << 3)
                 | (jnp.clip(meta[eg2.ROW_AD_RUN], 0, 63) << 4))
        # plain wrap-cast: the kmer rows are uint16-valued (the host
        # re-masks & 0xFFFF); every other row fits int16 natively
        return jnp.stack([flags] + [meta[r] for r in P1_META_ROWS],
                         axis=0).astype(jnp.int16)

    return fn


P1F_META_ROWS = (eg2.ROW_PS, eg2.ROW_PE, eg2.ROW_AE, eg2.ROW_TSO_END)
P1F_ROW_NAMES = ("flags", "ps", "pe", "ae", "tso_end", "kmer_lo", "kmer_hi")


def make_pass1_full_body(cfg: PipelineConfig):
    """Pass-1 'full' body for the cached two-pass pipeline: ONE edge scan
    emits both the pass-1 rows (used-list building) and everything pass 2
    needs except the whitelist sweep — finalized-able meta rows plus the
    BC search windows (packed 2 chars per int16 lane). Pass 2 then runs
    the sweep ALONE on the cached windows: no second fastq parse, no
    re-encode, no second edge scan, and the pass-2 upload drops from the
    full 2-bit composite (~160 B/read) to the windows (~22 B/read) —
    the reference scans the fastq twice end-to-end instead (two-pass
    NanoporeBC_UMI_finder, SURVEY.md)."""
    body = eg2.make_edge_scan2_packed(cfg)
    bw = eg2.bc_window_width(cfg)

    def fn(packed_tm, peq_ad, peq_adc, peq_tso):
        meta = body(packed_tm, peq_ad, peq_adc, peq_tso)
        flags = (meta[eg2.ROW_IS_FWD]
                 | (meta[eg2.ROW_STRANDED] << 1)
                 | (meta[eg2.ROW_HAS_POLYAT] << 2)
                 | (meta[eg2.ROW_KMER_VALID] << 3)
                 | (jnp.clip(meta[eg2.ROW_AD_RUN], 0, 63) << 4))
        wins = meta[eg2.ROW_BC0:eg2.ROW_BC0 + bw]             # [bw, S] i32
        if bw % 2:
            wins = jnp.concatenate([wins, jnp.zeros_like(wins[:1])], 0)
        wpack = wins[0::2] | (wins[1::2] << 8)   # codes <= 5: 2 per lane
        rows16 = jnp.stack(
            [flags]
            + [jnp.clip(meta[r], -I16_BIG, I16_BIG) for r in P1F_META_ROWS]
            + [meta[eg2.ROW_KMER_LO], meta[eg2.ROW_KMER_HI]], axis=0)
        return jnp.concatenate([rows16.astype(jnp.int16),
                                wpack.astype(jnp.int16)], axis=0)

    return fn


def make_sweep_only_body(cfg: PipelineConfig, mode: str, radius: int = 2,
                         K: int = 64):
    """Whitelist search alone over uploaded BC windows (u8 [bw, S]) — the
    cached pipeline's pass-2 device step (the edge scan already ran in
    pass 1). Same search modes and row semantics as
    make_scan_search2_body; returns i32 [4, S]: best_ed, best_idx,
    second_ed, overflow."""
    m = cfg.barcodes.cell_bc_length

    @jax.jit
    def fn(wins_u8, peq_bc, nvalid, qgram_t):
        best, overflow = _search_rows(mode, wins_u8.astype(jnp.int32),
                                      peq_bc, nvalid, qgram_t, m, radius, K)
        return jnp.stack([best[0], best[1], best[2], overflow],
                         axis=0).astype(jnp.int32)

    return fn


def _flat_span(inner, stack3, *args):
    """One call of `inner` over the whole span: [C, R, S] -> [rows, C*S].
    On an H100 80GB HBM3 (400 W limit) at 32k reads and 8k barcodes, one
    flat call ran in 18.0 ms where 2,048-read lax.map slices took 30.2 ms."""
    C, R, S = stack3.shape
    return inner(jnp.transpose(stack3, (1, 0, 2)).reshape(R, C * S), *args)


def make_mega2(inner):
    """Span dispatcher over [C, PACK_ROWS, S] slice stacks; returns
    [rows, C*S]."""
    return jax.jit(functools.partial(_flat_span, inner))


def make_sharded2(inner, mesh, n_args: int, data_axis: str = "data"):
    """Multi-chip v2 dispatcher: slice stacks data-parallel over the mesh
    (whitelist/patterns replicated; per-read rows need no collective).
    Returns [rows, C*S] — each device emits its contiguous column span."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = jax.shard_map(
        functools.partial(_flat_span, inner), mesh=mesh,
        in_specs=(P(data_axis),) + (P(),) * n_args,
        out_specs=P(None, data_axis), check_vma=False)
    sh = NamedSharding(mesh, P(data_axis))
    rep = NamedSharding(mesh, P())
    return jax.jit(sharded, in_shardings=(sh,) + (rep,) * n_args)


class ReadScanModel:
    """Host-side wrapper: owns pattern bitmasks + the jitted scan fns.

    With `mesh` (a jax.sharding.Mesh with a "data" axis) the fused pass-1
    and pass-2 dispatchers run sharded over the mesh — multi-chip as a
    pipeline mode, not a demo. Host-side outputs are identical to the
    one-device path (asserted in tests/test_multichip_pipeline.py)."""

    def __init__(self, cfg: PipelineConfig | None = None, mesh=None,
                 data_axis: str = "data"):
        self.cfg = cfg or PipelineConfig()
        self.mesh = mesh
        self.data_axis = data_axis
        self._gran = int(mesh.shape[data_axis]) if mesh is not None else 1
        self.is5p = getattr(self.cfg, "chemistry", "3p") == "5p"
        if self.is5p:
            a, t = self.cfg.adapter5p, self.cfg.tso5p
        else:
            a, t = self.cfg.adapter3p, self.cfg.tso3p
        self.peq_ad = jnp.asarray(editdist.build_peq(dna.encode(a.sequence)[None, :]))
        self.peq_adc = jnp.asarray(
            editdist.build_peq(dna.encode(a.sequence_complete)[None, :]))
        self.peq_tso = jnp.asarray(editdist.build_peq(dna.encode(t.sequence)[None, :]))
        self._edge_fn = make_edge_scan_packed_fn(self.cfg)
        self._internal_fn = make_internal_scan_fn(self.cfg)
        # jitted-closure cache keyed by (mode, radius, K); tiny key space,
        # deliberately unbounded (ADVICE r2: init here, not lazily)
        self._mega_cache: dict = {}

    @property
    def bc_window_width(self) -> int:
        return (self.cfg.barcodes.cell_bc_length
                + 2 * self.cfg.readscanner.test_plus_minus_pos + 2)

    def _pack_batch(self, codes: np.ndarray, lens):
        """Pad B to a power-of-two bucket (one compiled shape per bucket)
        and nibble-pack; returns (packed [Bp, E] uint8, lens_p, B)."""
        B = len(lens)
        Bp = bucket_length(max(B, 1), 256)
        L = codes.shape[1]
        if L % 2:
            codes = np.concatenate(
                [codes, np.full((B, 1), dna.PAD, np.int8)], axis=1)
            L += 1
        full = np.full((Bp, L), dna.PAD, dtype=np.int8)
        full[:B] = codes
        lens_p = np.zeros(Bp, dtype=np.int32)
        lens_p[:B] = lens
        return pack_nibbles_np(full), lens_p, B

    def __call__(self, seqs, quals, lens):
        """Edge scan on [B, L] int8 batches -> dict of np arrays (QVs are
        computed host-side from `quals`; only packed seqs ship to device)."""
        packed, lens_p, B = self._pack_batch(np.asarray(seqs, dtype=np.int8),
                                             lens)
        meta, wins = self._edge_fn(jnp.asarray(packed), jnp.asarray(lens_p),
                                   self.peq_ad, self.peq_adc, self.peq_tso)
        out = unpack_edge_meta(np.asarray(meta))
        out["bc_windows"] = np.asarray(wins)
        out = {k: v[..., :B] if v.ndim == 1 else v[:B]
               for k, v in out.items()}
        compute_qvs_np(np.asarray(quals, dtype=np.int8), lens, out,
                       self.cfg.barcodes.cell_bc_length, self.is5p)
        return out

    def scan_reads(self, seqs: list[bytes], quals: list[bytes]):
        """Composite edge scan of raw reads; coords remapped to true reads."""
        codes, qv, comp_lens, true_lens = encode_composite(seqs, quals)
        out = self(codes, qv, comp_lens)
        for key in ("ps", "pe", "ae", "x_start", "x_end"):
            out[key] = remap_composite(out[key], true_lens)
        out["true_lens"] = true_lens
        return out

    # -- fused scan + barcode search (pass-2 hot path) -------------------

    PREFILTER_MIN_BC = 2048  # below this the brute sweep is cheaper

    def prepare_search(self, patterns: np.ndarray, n_valid: int,
                       radius: int = 2, mode: str = "sweep",
                       K: int = 64):
        """Bind a used-barcode list ([N, m] int8 code matrix) for fused
        scan+search calls.

        `radius` is the dynamic-ED search radius (the bcMaxEditDistances
        cap): prefilter-mode results are exact within it and report
        not-found beyond it — the jar's enumeration-bailout semantics
        (SURVEY §2.a BarcodeMatchTester). mode "sweep" is the exact brute
        sweep over the whole used list (ops.bcsearch.sweep_top2);
        "prefilter" stays available for very large used lists where
        O(B*N*W) brute work eventually loses."""
        from sicelore_tpu.ops import bcsearch
        assert mode in SEARCH_MODES, mode
        nt = bcsearch.NT
        used_peq = editdist.build_peq(patterns) if len(patterns) else \
            np.zeros((4, 1), np.uint32)
        N = ((max(n_valid, 1) + nt - 1) // nt) * nt
        peq = np.zeros((4, N), dtype=np.uint32)
        peq[:, :used_peq.shape[1]] = used_peq
        self._peq_bc = jnp.asarray(peq)
        self._peq_raw = used_peq
        qt = np.zeros((256, N), np.float32)
        if mode == "prefilter" and len(patterns):
            qt[:, :patterns.shape[0]] = bcsearch.build_qgram_table(patterns)
        self._qgram_t = jnp.asarray(qt)
        self._nvalid = jnp.asarray([n_valid], dtype=jnp.int32)
        self._n_valid = n_valid
        self._radius = radius
        self._mode = mode
        # cache built closures so re-binding a used list (same mode/radius/K)
        # reuses the in-process jit cache instead of recompiling — rebinding
        # happens per run/file in demon mode and in warm benchmarks
        key = (mode, radius, K)
        fn = self._mega_cache.get(key)
        if fn is None:
            inner = make_scan_search2_body(self.cfg, mode, radius, K)
            if self.mesh is not None:
                fn = make_sharded2(inner, self.mesh, 6, self.data_axis)
            else:
                fn = make_mega2(inner)
            self._mega_cache[key] = fn
        self._mega_fn = fn

    # -- v2 dispatch helpers (text-major slice stacks) -------------------

    def _stack3(self, packed_tm: np.ndarray, B: int):
        """[PACK_ROWS, B] u8 -> ([C, PACK_ROWS, S] stack, greedy pow2
        spans); padding columns carry length 0 (inert reads)."""
        S = self.SLICE
        g = self._gran
        R = packed_tm.shape[0]
        C = max((B + S - 1) // S, 1)
        C = ((C + g - 1) // g) * g
        total = C * S
        if packed_tm.shape[1] != total:
            full = np.zeros((R, total), np.uint8)
            full[:, :packed_tm.shape[1]] = packed_tm
        else:
            full = packed_tm
        arr3 = np.ascontiguousarray(
            full.reshape(R, C, S).transpose(1, 0, 2))
        spans, c0 = [], 0
        while c0 < C:
            take = g
            while take * 2 <= min(self.MAX_C * g, C - c0):
                take *= 2
            spans.append((c0, take))
            c0 += take
        return arr3, spans

    def _jnp2(self):
        if not hasattr(self, "_jnp2_body"):
            self._jnp2_body = eg2.make_edge_scan2_jnp(self.cfg)
        return self._jnp2_body

    def _scan2_sync(self, seqs: list[bytes], quals: list[bytes],
                    with_search: bool):
        """Exact int8 fallback (N bases / overflow / split parts): jnp
        two-half body + full host finalization (+ whitelist search)."""
        from sicelore_tpu.ops import bcsearch
        head, tail, qv2, lens, qsum = eg2.encode_two_half_int8(seqs, quals)
        B = len(seqs)
        Bp = bucket_length(max(B, 1), 8)
        if Bp != B:
            pad_h = np.full((Bp - B, eg2.E), dna.PAD, np.int8)
            head = np.concatenate([head, pad_h])
            tail = np.concatenate([tail, pad_h])
            lens_p = np.concatenate([lens, np.zeros(Bp - B, np.int32)])
        else:
            lens_p = lens
        meta = np.asarray(self._jnp2()(
            jnp.asarray(head), jnp.asarray(tail),
            jnp.asarray(lens_p, dtype=jnp.int32),
            self.peq_ad, self.peq_adc, self.peq_tso))[:, :B]
        out = eg2.finalize_meta_np(meta, lens, self.cfg)
        eg2.compute_qvs2_np(qv2, lens, out,
                            self.cfg.barcodes.cell_bc_length, self.is5p,
                            qsum)
        if not with_search:
            return out, None
        bc = bcsearch.bc_search(out["bc_windows"].astype(np.int32),
                                self._peq_raw, self._n_valid,
                                self.cfg.barcodes.cell_bc_length)
        if self._mode == "prefilter":
            r = self._radius
            bc["ed2"] = np.where(bc["ed2"] > r, editdist.INT_MAX, bc["ed2"])
            over = bc["ed"] > r
            bc["ed"] = np.where(over, bcsearch_BIG_MIN, bc["ed"])
            bc["idx"] = np.where(over, bcsearch_BIG_MIN, bc["idx"])
        return out, bc

    def _slices(self, full: np.ndarray):
        """Cut the padded row matrix into a [C, SLICE, E] stack with C a
        multiple of the mesh data-axis size, plus the greedy dispatch spans
        (take = gran * 2^k, capped at MAX_C slices per device)."""
        S = self.SLICE
        g = self._gran
        rows = full.shape[0]
        C = max((rows + S - 1) // S, 1)
        C = ((C + g - 1) // g) * g
        if C * S != rows:
            pad = np.zeros((C * S - rows, full.shape[1]), np.uint8)
            full = np.concatenate([full, pad], axis=0)
        arr3 = full.reshape(C, S, -1)
        spans, c0 = [], 0
        while c0 < C:
            take = g
            while take * 2 <= min(self.MAX_C * g, C - c0):
                take *= 2
            spans.append((c0, take))
            c0 += take
        return arr3, spans

    def scan_pass1_async(self, seqs: list[bytes], quals: list[bytes]):
        """Dispatch v2 pass-1 without blocking; force with finish_pass1
        (double-buffered in the pipeline like pass 2)."""
        if not hasattr(self, "_pass1_mega2"):
            inner = make_pass1_body2(self.cfg)
            if self.mesh is not None:
                self._pass1_mega2 = make_sharded2(inner, self.mesh, 3,
                                                  self.data_axis)
            else:
                self._pass1_mega2 = make_mega2(inner)
        packed_tm, qv2, true_lens, dirty, qsum = eg2.encode_composite_tm(
            seqs, quals)
        B = len(seqs)
        if dirty.any():
            packed_tm[eg2.TEXT_ROWS:, dirty] = 0   # length 0: inert
        arr3, spans = self._stack3(packed_tm, B)
        parts = [self._pass1_mega2(jnp.asarray(arr3[c0:c0 + take]),
                                   self.peq_ad, self.peq_adc, self.peq_tso)
                 for c0, take in spans]
        _prefetch(parts)
        return parts, qv2, true_lens, dirty, seqs, quals, B, qsum

    def scan_pass1(self, seqs: list[bytes], quals: list[bytes]):
        """v2 pass-1: text-major packed composite -> edge meta + exact-BC
        kmer (true stranded coords). Reads with N bases re-run through the
        exact int8 fallback."""
        return self.finish_pass1(self.scan_pass1_async(seqs, quals))

    def finish_pass1(self, handles):
        parts, qv2, true_lens, dirty, seqs, quals, B, qsum = handles
        arr = np.concatenate([np.asarray(h) for h in parts],
                             axis=1)[:, :B]
        out = finalize_rows_np(arr, P1_ROW_NAMES, true_lens, self.cfg)
        eg2.compute_qvs2_np(qv2, true_lens, out,
                            self.cfg.barcodes.cell_bc_length, self.is5p,
                            qsum, need_x=False)
        if dirty.any():
            idxs = np.nonzero(dirty)[0]
            sub, _ = self._scan2_sync([seqs[i] for i in idxs],
                                      [quals[i] for i in idxs], False)
            for k, v in sub.items():
                if k in out and out[k].ndim == 1:
                    out[k][idxs] = v
        return out

    # -- pass-1 FULL variant + sweep-only pass-2 (cached pipeline) -------

    def scan_pass1_full_async(self, seqs: list[bytes], quals: list[bytes]):
        """Dispatch the pass-1 FULL scan (edge meta + BC windows, see
        make_pass1_full_body); force with finish_pass1_full."""
        if not hasattr(self, "_pass1_full_mega"):
            inner = make_pass1_full_body(self.cfg)
            if self.mesh is not None:
                self._pass1_full_mega = make_sharded2(inner, self.mesh, 3,
                                                      self.data_axis)
            else:
                self._pass1_full_mega = make_mega2(inner)
        packed_tm, qv2, true_lens, dirty, qsum = eg2.encode_composite_tm(
            seqs, quals)
        B = len(seqs)
        if dirty.any():
            packed_tm[eg2.TEXT_ROWS:, dirty] = 0   # length 0: inert
        arr3, spans = self._stack3(packed_tm, B)
        parts = [self._pass1_full_mega(jnp.asarray(arr3[c0:c0 + take]),
                                       self.peq_ad, self.peq_adc,
                                       self.peq_tso)
                 for c0, take in spans]
        _prefetch(parts)
        return parts, qv2, true_lens, dirty, seqs, quals, B, qsum

    def finish_pass1_full(self, handles):
        """-> (out dict — superset of finish_pass1's, with finalized
        ps/pe/ae/tso/x windows and all three QV means — and the BC search
        windows as u8 [bw, B] for the pass-2 sweep)."""
        parts, qv2, true_lens, dirty, seqs, quals, B, qsum = handles
        arr = np.concatenate([np.asarray(h) for h in parts],
                             axis=1)[:, :B]
        nf = len(P1F_ROW_NAMES)
        out = finalize_rows_np(arr[:nf], P1F_ROW_NAMES, true_lens,
                               self.cfg)
        eg2.compute_qvs2_np(qv2, true_lens, out,
                            self.cfg.barcodes.cell_bc_length, self.is5p,
                            qsum)
        bw = self.bc_window_width
        wrows = arr[nf:].astype(np.int32) & 0xFFFF
        wins = np.empty((wrows.shape[0] * 2, B), np.uint8)
        wins[0::2] = (wrows & 0xFF).astype(np.uint8)
        wins[1::2] = (wrows >> 8).astype(np.uint8)
        wins = wins[:bw]
        if dirty.any():
            idxs = np.nonzero(dirty)[0]
            sub, _ = self._scan2_sync([seqs[i] for i in idxs],
                                      [quals[i] for i in idxs], False)
            for k, v in sub.items():
                if k in out and out[k].ndim == 1:
                    out[k][idxs] = v
            wins[:, idxs] = np.clip(sub["bc_windows"], 0, 255
                                    ).astype(np.uint8).T
        return out, wins

    def bc_sweep_async(self, windows_tm: np.ndarray):
        """Dispatch the whitelist search alone on cached pass-1 BC windows
        (u8 [bw, B]); force with finish_bc_sweep. Requires
        prepare_search."""
        if not hasattr(self, "_sweep_only_fn"):
            fn = make_sweep_only_body(self.cfg, self._mode, self._radius)
            if self.mesh is not None:
                from jax.sharding import NamedSharding
                from jax.sharding import PartitionSpec as P
                sh = NamedSharding(self.mesh, P(None, self.data_axis))
                rep = NamedSharding(self.mesh, P())
                self._sweep_only_fn = jax.jit(
                    fn, in_shardings=(sh, rep, rep, rep))
            else:
                self._sweep_only_fn = fn
        B = windows_tm.shape[1]
        Bp = bucket_length(max(B, 1), 2048 * self._gran)
        w = windows_tm
        if Bp != B:
            w = np.zeros((windows_tm.shape[0], Bp), np.uint8)
            w[:, :B] = windows_tm
        h = self._sweep_only_fn(jnp.asarray(w), self._peq_bc, self._nvalid,
                                self._qgram_t)
        _prefetch([h])
        return h, windows_tm, B

    def finish_bc_sweep(self, handle):
        """-> bc dict {ed, idx, ed2} with the same not-found/overflow
        semantics as finish_search's fused rows."""
        from sicelore_tpu.ops import bcsearch
        h, wins, B = handle
        arr = np.asarray(h)[:, :B].astype(np.int64)
        ed = np.where(arr[0] >= I16_BIG, bcsearch_BIG_MIN, arr[0])
        ed2 = np.where(arr[2] >= I16_BIG, editdist.INT_MAX, arr[2])
        bc = {"ed": ed, "idx": arr[1], "ed2": ed2}
        redo = arr[3] != 0
        if redo.any():
            idxs = np.nonzero(redo)[0]
            sub = bcsearch.bc_search(
                wins[:, idxs].T.astype(np.int32), self._peq_raw,
                self._n_valid, self.cfg.barcodes.cell_bc_length)
            if self._mode == "prefilter":
                r = self._radius
                sub["ed2"] = np.where(sub["ed2"] > r, editdist.INT_MAX,
                                      sub["ed2"])
                over = sub["ed"] > r
                sub["ed"] = np.where(over, bcsearch_BIG_MIN, sub["ed"])
                sub["idx"] = np.where(over, bcsearch_BIG_MIN, sub["idx"])
            for k in bc:
                bc[k][idxs] = sub[k]
        return bc

    # dispatch granularity: chunks pad to whole SLICE-read slices, grouped
    # into power-of-two spans of at most MAX_C slices per device call, so
    # a handful of compiled shapes serve every chunk size.
    SLICE = 2048

    MAX_C = 16  # max slices per mega dispatch (one RPC pair each way)

    def scan_search_async(self, seqs: list[bytes], quals: list[bytes]):
        """Dispatch the v2 fused edge scan + BC search; returns device
        handles WITHOUT blocking — force with `finish_search` while the
        device works on the next batch.

        The text-major packed composite rides span batches (greedy
        power-of-two span decomposition bounds compiled shapes); each
        slice's BC windows feed the whitelist sweep text-major. Reads with
        N bases upload with length 0 and re-run through the exact int8
        path in finish_search."""
        packed_tm, qv2, true_lens, dirty, qsum = eg2.encode_composite_tm(
            seqs, quals)
        B = len(seqs)
        if dirty.any():
            packed_tm[eg2.TEXT_ROWS:, dirty] = 0
        arr3, spans = self._stack3(packed_tm, B)
        parts = [self._mega_fn(jnp.asarray(arr3[c0:c0 + take]), self.peq_ad,
                               self.peq_adc, self.peq_tso, self._peq_bc,
                               self._nvalid, self._qgram_t)
                 for c0, take in spans]
        _prefetch(parts)
        return parts, qv2, true_lens, dirty, seqs, quals, B, qsum

    def _scan_search_sync(self, seqs: list[bytes], quals: list[bytes]):
        """Exact int8 fallback (handles N bases; serves dirty/overflow
        reads and re-scanned split parts). Brute-sweeps the whole used
        list; in prefilter mode the results are radius-masked to match
        the fused path's semantics."""
        return self._scan2_sync(seqs, quals, True)

    def finish_search(self, handles):
        """Force a scan_search_async result -> (edge dict, best dict)."""
        parts, qv2, true_lens, dirty, seqs, quals, B, qsum = handles
        arr = np.concatenate([np.asarray(h) for h in parts],
                             axis=1)[:, :B]
        out = finalize_rows_np(arr, P2_ROW_NAMES, true_lens, self.cfg)
        # pass-2 emit consumes only x_qv (bc/read QV are pass-1 criteria)
        eg2.compute_qvs2_np(qv2, true_lens, out,
                            self.cfg.barcodes.cell_bc_length, self.is5p,
                            qsum, need_bc=False, need_read=False)
        idx = (out["idx_lo"] & 0xFFFF) | (out["idx_hi"] << 16)
        ed = np.where(out["best_ed"] >= I16_BIG, bcsearch_BIG_MIN,
                      out["best_ed"])
        ed2 = np.where(out["second_ed"] >= I16_BIG, editdist.INT_MAX,
                       out["second_ed"])
        bc = {"ed": ed, "idx": idx, "ed2": ed2}
        redo = dirty | (out["overflow"] != 0)
        if redo.any():
            idxs = np.nonzero(redo)[0]
            sub_out, sub_bc = self._scan_search_sync(
                [seqs[i] for i in idxs], [quals[i] for i in idxs])
            for k, v in sub_out.items():
                if k in out and out[k].ndim == 1:
                    out[k][idxs] = v
            for k in bc:
                bc[k][idxs] = sub_bc[k]
        return out, bc

    # -- tiled internal/chimera scan (async pass-2 hot path) -------------

    def internal_tiles_async(self, seqs: list[bytes]):
        """Dispatch the tiled chimera scan for a chunk; None when no read
        is long enough. Force with finish_internal_tiles."""
        rows, read_idx, g0s = build_tiles(seqs, self.cfg)
        if len(rows) == 0:
            return None
        if not hasattr(self, "_tile_fn"):
            if self.mesh is not None:
                self._tile_fn = make_internal_tile_sharded_fn(
                    self.cfg, self.mesh, self.data_axis)
            else:
                self._tile_fn = make_internal_tile_map_fn(self.cfg)
        arr3, spans = self._slices(rows)
        parts = [self._tile_fn(jnp.asarray(arr3[c0:c0 + take]),
                               self.peq_adc)
                 for c0, take in spans]
        _prefetch(parts)
        return parts, read_idx, g0s, len(rows)

    def finish_internal_tiles(self, handle):
        """-> (splits {read_idx: [global split pos]} for single-junction
        reads, discard set for multi-junction reads)."""
        if handle is None:
            return {}, set()
        parts, read_idx, g0s, T = handle
        arr = np.concatenate(
            [np.asarray(h).transpose(1, 0, 2).reshape(3, -1)
             for h in parts], axis=1)[:, :T].astype(np.int32)
        n, s0, s1 = arr[0], arr[1], arr[2]
        hot = np.nonzero(n > 0)[0]
        per_read: dict[int, set] = {}
        for t in hot:
            r = int(read_idx[t])
            g = int(g0s[t])
            ps = per_read.setdefault(r, set())
            if n[t] >= 1 and s0[t] >= 0:
                ps.add(g + int(s0[t]))
            if n[t] >= 2 and s1[t] >= 0:
                ps.add(g + int(s1[t]))
            if n[t] > 2:
                ps.add(-1)  # >2 distinct in one tile: multi-chimeric
        splits: dict[int, list[int]] = {}
        discard: set[int] = set()
        for r, ps in per_read.items():
            if -1 in ps or len(ps) > 1:
                discard.add(r)
            elif len(ps) == 1:
                splits[r] = sorted(ps)
        return splits, discard

    def scan_internal(self, seqs, lens):
        """Internal/chimera scan on full-length [B, L] batches (B padded to
        a power-of-two bucket to bound compile count)."""
        B = len(lens)
        Bp = bucket_length(max(B, 1), 8)
        if Bp != B:
            seqs = np.concatenate(
                [seqs, np.full((Bp - B, seqs.shape[1]), dna.PAD, np.int8)])
            lens = np.concatenate([lens, np.zeros(Bp - B, np.int32)])
        meta = self._internal_fn(jnp.asarray(seqs),
                                 jnp.asarray(lens, dtype=jnp.int32),
                                 self.peq_adc)
        out = unpack_internal_meta(np.asarray(meta))
        return {k: v[:B] for k, v in out.items()}


def _prefetch(parts) -> None:
    """Start device->host copies of dispatched results immediately, so
    transfers overlap the host's emit work for the previous chunk instead
    of blocking in np.asarray."""
    for h in parts:
        h.copy_to_host_async()


def bucket_length(n: int, minimum: int = 256) -> int:
    """Round a read length up to the next power-of-two bucket."""
    b = minimum
    while b < n:
        b *= 2
    return b
