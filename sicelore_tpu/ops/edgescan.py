"""Two-half composite edge scan: text-major packed layout + jnp body.

Each read is spliced into a composite of TWO INDEPENDENT HALVES:

  * head [E]: first min(L, E) bases, LEFT-aligned  (all REV polyT / 5'
    evidence lives here)
  * tail [E]: last  min(L, E) bases, RIGHT-aligned (all FWD polyA / 3'
    evidence; the read END is always at column E-1)

Right-aligning the tail makes every window's geometry uniform in array
coordinates — the FWD polyA region is always the last `window` columns, the
rc sweeps always start at column E-1 — and the whole batch ships
TEXT-MAJOR ([ROWS, B] 2-bit packed, 4 bases per byte), a quarter of the
byte-code upload.

Semantics vs the contiguous composite (models.readscan.make_edge_scan_fn):
identical for reads where each end's evidence lies within E bases of that
end — i.e. everything except reads shorter than 2E whose polyA/T RUN WALK
crosses more than E bases from the end (a >140 bp homopolymer run: the walk
clamps at the half boundary exactly like it already clamped for reads
longer than 2E). Coordinate rows are half-local and finalized to true
stranded read coordinates on the host (`finalize_meta_np`).

Reference behavior spec: the reference config.xml polyAT / adapters / TSO
sections (summarized in SURVEY.md) — same contract as the contiguous scan.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from sicelore_tpu.ops import scan
from sicelore_tpu.utils import dna
from sicelore_tpu.utils.config import PipelineConfig

E = 304          # bases per half (>= polyA window 150 + adapter window 110)
TEXT_ROWS = 2 * E // 4          # 152 packed text rows (4 bases/byte)
NMETA_ROWS = 4                  # little-endian true-length rows
PACK_ROWS = TEXT_ROWS + NMETA_ROWS
BIG = 10**9

# meta row indices of the body output ([NROWS(cfg), B] int32). Coordinate
# rows are HALF-LOCAL (< 2E, int16-safe for the packed download even on
# arbitrarily long reads): for FWD reads they are tail-half columns, for
# REV reads head-half columns; `finalize_meta_np` maps them to true
# stranded read coordinates on the host.
(ROW_IS_FWD, ROW_STRANDED, ROW_HAS_POLYAT, ROW_PS, ROW_PE, ROW_AE,
 ROW_AD_ED, ROW_ADC_ED, ROW_AD_RUN, ROW_TSO_END, ROW_TSO_ED,
 ROW_KMER_LO, ROW_KMER_HI, ROW_KMER_VALID) = range(14)
ROW_BC0 = 14


def bc_window_width(cfg: PipelineConfig) -> int:
    return (cfg.barcodes.cell_bc_length
            + 2 * cfg.readscanner.test_plus_minus_pos + 2)


def n_rows(cfg: PipelineConfig) -> int:
    return ROW_BC0 + bc_window_width(cfg)


# ---------------------------------------------------------------------------
# Host-side encoding (numpy fallback; native/hostenc provides the fast path)
# ---------------------------------------------------------------------------

_ENC_PAD0 = dna._ENC.copy()
_ENC_PAD0[0] = dna.PAD  # NUL byte = padding in the bulk-encode fast path


def encode_composite_tm(seqs: list[bytes], quals: list[bytes]):
    """Encode reads into the two-half text-major packed layout.

    Returns (packed_tm [PACK_ROWS, B] uint8, qv2 [B, 2E] int8 — head quals
    left-aligned in cols [0, E), tail quals right-aligned in [E, 2E) —
    true_lens [B] int32, dirty [B] bool, qsum [B] int32). Reads containing
    a non-ACGT base inside either half are `dirty` (2 bits cannot encode N;
    they re-run through the exact 4-bit fallback path)."""
    from sicelore_tpu.io import native as _native
    ext = _native.get_hostenc()
    if ext is not None and hasattr(ext, "encode_composite_tm"):
        B = len(seqs)
        p, q, tl, dr, qs = ext.encode_composite_tm(seqs, quals, E)
        packed = np.frombuffer(p, np.uint8).reshape(PACK_ROWS, B)
        qv2 = np.frombuffer(q, np.int8).reshape(B, 2 * E)
        return (packed, qv2, np.frombuffer(tl, np.int32),
                np.frombuffer(dr, np.uint8).astype(bool),
                np.frombuffer(qs, np.int32))
    B = len(seqs)
    z = b"\x00"
    true_lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=B)
    sbuf = b"".join(s[:E].ljust(E, z) + s[-E:].rjust(E, z) for s in seqs)
    codes = _ENC_PAD0[np.frombuffer(sbuf, np.uint8)].reshape(B, 2 * E)
    qbuf = b"".join(q[:E].ljust(E, z) + q[-E:].rjust(E, z) for q in quals)
    qarr = np.frombuffer(qbuf, np.uint8).reshape(B, 2 * E)
    qv2 = np.where(qarr >= 33, qarr.astype(np.int16) - 33, 0).astype(np.int8)
    cols = np.arange(2 * E, dtype=np.int32)[None, :]
    hl = np.minimum(true_lens, E)[:, None]
    valid = (cols < hl) | (cols >= 2 * E - hl)
    dirty = ((codes == dna.N_CODE) & valid).any(axis=1)
    # per-read qual sum over the TRUE read (head + non-overlapping tail part)
    tshift = np.maximum(true_lens - E, 0)[:, None]  # tail bases not in head
    qs_m = (cols < hl) | (cols >= 2 * E - tshift)
    qsum = np.where(qs_m, qv2.astype(np.int32), 0).sum(axis=1)
    c = np.minimum(codes, 3).astype(np.uint8)
    packed = ((c[:, 0::4] << 6) | (c[:, 1::4] << 4)
              | (c[:, 2::4] << 2) | c[:, 3::4])          # [B, TEXT_ROWS]
    out = np.empty((PACK_ROWS, B), np.uint8)
    out[:TEXT_ROWS] = packed.T
    out[TEXT_ROWS:] = true_lens.astype("<u4").view(np.uint8).reshape(B, 4).T
    return out, qv2, true_lens, dirty, qsum


def encode_two_half_int8(seqs: list[bytes], quals: list[bytes]):
    """Exact int8 two-half encoding (N-safe; serves dirty/fallback reads).

    Returns (head [B, E] i8, tail [B, E] i8 — PAD outside the read —
    qv2 [B, 2E] i8, true_lens [B] i32, qsum [B] i32)."""
    B = len(seqs)
    z = b"\x00"
    true_lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=B)
    sbuf = b"".join(s[:E].ljust(E, z) + s[-E:].rjust(E, z) for s in seqs)
    codes = _ENC_PAD0[np.frombuffer(sbuf, np.uint8)].reshape(B, 2 * E)
    qbuf = b"".join(q[:E].ljust(E, z) + q[-E:].rjust(E, z) for q in quals)
    qarr = np.frombuffer(qbuf, np.uint8).reshape(B, 2 * E)
    qv2 = np.where(qarr >= 33, qarr.astype(np.int16) - 33, 0).astype(np.int8)
    cols = np.arange(2 * E, dtype=np.int32)[None, :]
    hl = np.minimum(true_lens, E)[:, None]
    codes = np.where((cols < hl) | (cols >= 2 * E - hl), codes,
                     np.int8(dna.PAD))
    tshift = np.maximum(true_lens - E, 0)[:, None]
    qs_m = (cols < hl) | (cols >= 2 * E - tshift)
    qsum = np.where(qs_m, qv2.astype(np.int32), 0).sum(axis=1)
    return codes[:, :E], codes[:, E:], qv2, true_lens, qsum


def unpack_tm(packed_tm: jax.Array):
    """Device-side inverse: [PACK_ROWS, B] u8 -> (head [B, E] i8,
    tail [B, E] i8 — PAD-masked outside the read — lens [B] i32)."""
    text = packed_tm[:TEXT_ROWS]
    lb = packed_tm[TEXT_ROWS:].astype(jnp.int32)
    lens = (lb[0] | (lb[1] << 8) | (lb[2] << 16) | (lb[3] << 24))
    parts = [((text >> s) & jnp.uint8(3)).astype(jnp.int8) for s in (6, 4, 2, 0)]
    codes = jnp.stack(parts, axis=1).reshape(4 * TEXT_ROWS, -1)   # [2E, B]
    codes = jnp.transpose(codes)                          # [B, 2E]
    head, tail = codes[:, :E], codes[:, E:]
    cols = jnp.arange(E, dtype=jnp.int32)[None, :]
    hl = jnp.minimum(lens, E)[:, None]
    head = jnp.where(cols < hl, head, jnp.int8(dna.PAD))
    tail = jnp.where(cols >= E - hl, tail, jnp.int8(dna.PAD))
    return head, tail, lens


# ---------------------------------------------------------------------------
# jnp body (every backend; XLA fuses the unrolled per-read chains)
# ---------------------------------------------------------------------------

def make_edge_scan2_jnp(cfg: PipelineConfig):
    """Two-half jnp edge scan: body(head, tail, lens, peq_ad, peq_adc,
    peq_tso) -> meta [n_rows(cfg), B] int32 (true stranded coords)."""
    p = cfg.polyat
    is5p = getattr(cfg, "chemistry", "3p") == "5p"
    a = cfg.adapter5p if is5p else cfg.adapter3p
    t = cfg.tso5p if is5p else cfg.tso3p
    bc_len = cfg.barcodes.cell_bc_length
    pad = cfg.readscanner.test_plus_minus_pos
    k = p.polyat_length
    min_count = scan.min_count_for(k, p.fraction_at_in_polyat)
    win_p = p.window_search_for_polya
    awin = a.adapter_search_window
    twin = t.window_for_tso_search
    m_ad = len(a.sequence)
    m_adc = len(a.sequence_complete)
    m_tso = len(t.sequence)
    bc_win = bc_len + 2 * pad + 2
    nbases = cfg.readscanner.nbases_of_adapter_seq_in_readname
    x_len = 40 + nbases
    adc_codes = jnp.asarray(dna.encode(a.sequence_complete))
    tso_codes = jnp.asarray(dna.encode(t.sequence))

    @jax.jit
    def body(head, tail, lens, peq_ad, peq_adc, peq_tso):
        B = head.shape[0]
        head_len = jnp.minimum(lens, E)
        tail_start = E - head_len                    # first in-read tail col
        tshift = lens - E                            # tail col -> true coord
        elen = jnp.full((B,), E, jnp.int32)

        # ---- polyT near the read start (REV) / polyA near the end (FWD) --
        rev_found, rev_ts, rev_te = scan.polyat_find(
            head, head_len, base=dna.T, k=k, min_count=min_count,
            window=win_p, from_end=False)
        fwd_found, fwd_ps, fwd_pe = scan.polyat_find(
            tail, elen, base=dna.A, k=k, min_count=min_count,
            window=win_p, from_end=True, start_min=tail_start)

        # ---- adapter search, sense-orientation windows ----
        from sicelore_tpu.models.readscan import gather_window
        if is5p:
            w_fwd = gather_window(head, head_len, jnp.zeros_like(lens), awin)
            w_rev = gather_window(tail, elen, elen - awin, awin, rc=True)
        else:
            w_fwd = gather_window(tail, elen, fwd_pe + 1, awin, rc=True)
            w_rev = gather_window(head, head_len, rev_ts - awin, awin)
        ed2, pos2 = scan.adapter_search(
            jnp.concatenate([w_fwd, w_rev], axis=0), peq_ad, m_ad)
        ed_f, ed_r = ed2[:B], ed2[B:]
        pos_f, pos_r = pos2[:B], pos2[B:]
        ed_f = jnp.where(fwd_found, ed_f, BIG)
        ed_r = jnp.where(rev_found, ed_r, BIG)

        ok_f = fwd_found & (ed_f <= a.max_needleman_mismatches)
        ok_r = rev_found & (ed_r <= a.max_needleman_mismatches)
        is_fwd = ok_f & (~ok_r | (ed_f <= ed_r))
        stranded = ok_f | ok_r
        is_fwd = jnp.where(stranded, is_fwd, fwd_found)

        # half-local coordinate rows (host finalizes to stranded coords)
        has_pat = jnp.where(is_fwd, fwd_found, rev_found)
        ps_loc = jnp.where(is_fwd, fwd_ps, rev_te)
        pe_loc = jnp.where(is_fwd, fwd_pe, rev_ts)

        if is5p:
            ae_loc = jnp.where(is_fwd, pos_f, pos_r)   # already stranded
        else:
            ae_loc = jnp.where(is_fwd, fwd_pe + awin - pos_f,
                               rev_ts - awin + pos_r)
        ad_ed = jnp.where(is_fwd, ed_f, ed_r)
        ad_pos_local = jnp.where(is_fwd, pos_f, pos_r)

        w_used = jnp.where(is_fwd[:, None], w_fwd, w_rev)
        edc, _ = scan.adapter_search(w_used, peq_adc, m_adc)
        ad_runs, _ = scan.match_run_stats(w_used, adc_codes, m_adc)

        bc_start_local = ad_pos_local + 1 - pad
        bc_windows = gather_window(w_used, jnp.full((B,), awin, jnp.int32),
                                   bc_start_local, bc_win)

        # ---- TSO (stranded positions are < t0 + twin + 16: int16-safe) --
        # 5p: the window starts after the BC, from the STRANDED-masked ae
        # (unstranded reads search [bc_len, bc_len + twin) like the round-3
        # body, whose masked ae = -1 fed this formula)
        t0 = (jnp.where(stranded, ae_loc, -1) + 1 + bc_len) if is5p \
            else jnp.zeros_like(lens)
        w5_f = gather_window(head, head_len, t0, twin)
        w5_r = gather_window(tail, elen, elen - twin - t0, twin, rc=True)
        w5 = jnp.where(is_fwd[:, None], w5_f, w5_r)
        tso_ed, tso_pos = scan.adapter_search(w5, peq_tso, m_tso)
        # TSO consecutive-match bailouts (config.xml:160-166): the match
        # passes even above maxNeedlemanMismatches when a consecutive
        # match run >= minTSO_NeedlemanConsecutiveMatches exists, or two
        # disjoint runs sum to >= minTSO_TwoBestConsecutiveMatches
        bail = scan.run_bailout(w5, tso_codes, m_tso,
                                t.min_tso_consecutive_matches,
                                t.min_tso_two_best_consecutive_matches)
        tso_found = (tso_ed <= t.max_needleman_mismatches) | bail
        tso_end = jnp.where(tso_found,
                            t0 + tso_pos + (t.offset_tso_end - 1), -1)

        # ---- BC kmer (pass-1 exact match) ----
        codes = bc_windows[:, pad:pad + bc_len].astype(jnp.uint32)
        kvalid = jnp.all(codes < 4, axis=1)
        kmer = jnp.zeros(B, jnp.uint32)
        for i in range(bc_len):
            kmer = (kmer << jnp.uint32(2)) | jnp.minimum(codes[:, i], 3)

        rows = [None] * ROW_BC0
        rows[ROW_IS_FWD] = is_fwd.astype(jnp.int32)
        rows[ROW_STRANDED] = stranded.astype(jnp.int32)
        rows[ROW_HAS_POLYAT] = has_pat.astype(jnp.int32)
        rows[ROW_PS] = ps_loc
        rows[ROW_PE] = pe_loc
        rows[ROW_AE] = ae_loc
        rows[ROW_AD_ED] = jnp.where(stranded, jnp.minimum(ad_ed, 16384),
                                    16384)
        rows[ROW_ADC_ED] = edc
        rows[ROW_AD_RUN] = ad_runs
        rows[ROW_TSO_END] = tso_end
        rows[ROW_TSO_ED] = tso_ed
        rows[ROW_KMER_LO] = (kmer & 0xFFFF).astype(jnp.int32)
        rows[ROW_KMER_HI] = (kmer >> 16).astype(jnp.int32)
        rows[ROW_KMER_VALID] = kvalid.astype(jnp.int32)
        meta = jnp.stack(rows, axis=0)
        return jnp.concatenate(
            [meta, jnp.transpose(bc_windows).astype(jnp.int32)], axis=0)

    return body


def make_edge_scan2_packed(cfg: PipelineConfig):
    """Body over the text-major packed input: fn(packed_tm [PACK_ROWS, B]
    u8, peq_ad, peq_adc, peq_tso) -> meta [n_rows(cfg), B] i32."""
    body = make_edge_scan2_jnp(cfg)

    def fn(packed_tm, peq_ad, peq_adc, peq_tso):
        head, tail, lens = unpack_tm(packed_tm)
        return body(head, tail, lens, peq_ad, peq_adc, peq_tso)

    return fn


ED_SENTINEL = 16384  # int16-safe not-found marker in ROW_AD_ED


def finalize_meta_np(meta: np.ndarray, true_lens: np.ndarray,
                     cfg: PipelineConfig) -> dict:
    """[n_rows, B] i32 half-local rows -> the edge dict of models.readscan
    in TRUE STRANDED coordinates (host side, vectorized).

    FWD coordinate rows are tail-half columns (true = col + L - E); REV
    rows are head columns q (stranded = L - 1 - q). The local rows are
    int16-safe regardless of read length — that keeps the device download
    2 bytes/row even for >32 kb reads."""
    L = np.asarray(true_lens).astype(np.int64)
    is_fwd = meta[ROW_IS_FWD] != 0
    stranded = meta[ROW_STRANDED] != 0
    has_pat = meta[ROW_HAS_POLYAT] != 0
    shift = L - E
    is5p = getattr(cfg, "chemistry", "3p") == "5p"

    def fin(loc, flip_rev=True):
        loc = loc.astype(np.int64)
        return np.where(is_fwd, loc + shift,
                        (L - 1 - loc) if flip_rev else loc)

    ps = np.where(has_pat, fin(meta[ROW_PS]), -1)
    pe = np.where(has_pat, fin(meta[ROW_PE]), -1)
    if is5p:
        ae = np.where(stranded, meta[ROW_AE].astype(np.int64), -1)
    else:
        ae = np.where(stranded, fin(meta[ROW_AE]), -1)
    nbases = cfg.readscanner.nbases_of_adapter_seq_in_readname
    x_len = 40 + nbases
    if is5p:
        xs = ae - nbases + 1
        xe = ae + (x_len - nbases)
    else:
        xs = ae - (x_len - nbases)
        xe = ae + nbases - 1
    ad_ed = meta[ROW_AD_ED].astype(np.int64)
    out = {
        "is_fwd": is_fwd, "stranded": stranded, "has_polyat": has_pat,
        "ps": ps, "pe": pe, "ae": ae,
        "adapter_ed": np.where(ad_ed >= ED_SENTINEL, BIG, ad_ed),
        "adapter_complete_ed": meta[ROW_ADC_ED],
        "adapter_run": meta[ROW_AD_RUN],
        "tso_end": meta[ROW_TSO_END], "tso_ed": meta[ROW_TSO_ED],
        "x_start": xs, "x_end": xe,
        "bc_kmer": ((meta[ROW_KMER_HI].astype(np.int64) << 16)
                    | (meta[ROW_KMER_LO].astype(np.int64) & 0xFFFF)
                    ).astype(np.uint32),
        "bc_kmer_valid": meta[ROW_KMER_VALID] != 0,
        "true_lens": np.asarray(true_lens),
    }
    out["bc_windows"] = meta[ROW_BC0:].T.astype(np.int8)
    return out


def compute_qvs2_np(qv2: np.ndarray, true_lens: np.ndarray, out: dict,
                    bc_len: int, is5p: bool = False,
                    qsum: np.ndarray | None = None,
                    need_bc: bool = True, need_x: bool = True,
                    need_read: bool = True) -> None:
    """Host-side QV means over the two-half qual matrix (true stranded
    coordinates in `out`). Mirrors models.readscan.compute_qvs_np; the
    column map sends true coord q to head col q (q < E) or tail col
    q - L + 2E. The need_* flags skip windows a pass never consumes
    (pass 2 reads only x_qv, pass 1 only read/bc_qv) — each window mean
    costs ~20 ms per 32k reads in numpy."""
    B = qv2.shape[0]
    L2 = 2 * E
    lens = np.asarray(true_lens).astype(np.int64)
    if qsum is None:
        cols = np.arange(L2, dtype=np.int32)[None, :]
        hl = np.minimum(lens, E)[:, None]
        tshift = np.maximum(lens - E, 0)[:, None]
        qs_m = (cols < hl) | (cols >= L2 - tshift)
        qsum = np.where(qs_m, qv2.astype(np.int32), 0).sum(axis=1)
    # mean over the composite quals (min(L, 2E) distinct positions) — the
    # contiguous path's semantic: for reads longer than the composite the
    # read QV is the head+tail mean, not sum/L
    if need_read:
        out["read_qv"] = (qsum / np.maximum(np.minimum(lens, L2), 1)
                          ).astype(np.float32)
    is_fwd = out["is_fwd"]
    ae = out["ae"]
    rows = np.arange(B)[:, None]

    def window_mean(s_str, e_str):
        s = np.where(is_fwd, s_str, lens - 1 - e_str).astype(np.int64)
        e = np.where(is_fwd, e_str, lens - 1 - s_str).astype(np.int64)
        from sicelore_tpu.io import native as _native
        ext = _native.get_hostenc()
        if ext is not None and hasattr(ext, "window_qv_means"):
            buf = ext.window_qv_means(
                np.ascontiguousarray(qv2, dtype=np.int8), B, E,
                np.ascontiguousarray(lens), np.ascontiguousarray(s),
                np.ascontiguousarray(e))
            return np.frombuffer(buf, np.float32).copy()
        s = np.clip(s, 0, None)
        e1 = np.minimum(e + 1, lens)
        n = np.maximum(e1 - s, 1)
        Wm = max(int(np.max(n, initial=1)), 1)
        q = s[:, None] + np.arange(Wm, dtype=np.int64)       # true coords
        m = q < e1[:, None]
        col = np.where(q < E, q, q - lens[:, None] + L2)
        col = np.clip(col, 0, L2 - 1)
        w = qv2[rows, col].astype(np.int32)
        return ((w * m).sum(axis=1) / n).astype(np.float32)

    if need_x and "x_start" in out:
        out["x_qv"] = window_mean(out["x_start"], out["x_end"])
    if need_bc:
        if is5p:
            out["bc_qv"] = window_mean(ae + 1, ae + bc_len)
        else:
            out["bc_qv"] = window_mean(ae - bc_len, ae - 1)
