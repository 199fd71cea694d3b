// sicelore_hostenc — CPython extension for the host-side encode hot path.
//
// The pass-1/pass-2 device dispatch needs every fastq chunk turned into a
// fixed-shape 2-bit composite (head+tail splice) plus qual matrix; the
// numpy implementation (readscan.encode_composite_2bit) spends ~8us/read
// in per-read slicing — at 32k-read chunks that is the single largest
// host term of the scan budget.  This extension does
// the same transform with per-read memcpy + table lookups, multithreaded,
// and is byte-identical to the numpy path (asserted in
// tests/test_readscan.py::test_native_encode_matches_numpy).
//
// Reference role: the jar's FastqRecordExt/TwoBit encode stage inside
// WorkerReadscanner (binary; SURVEY §2.a "Barcode assigner" row).
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <string>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// byte -> 2-bit code; 0xFF marks non-ACGT (dirty)
uint8_t ENC[256];
struct EncInit {
  EncInit() {
    memset(ENC, 0xFF, sizeof(ENC));
    const char *u = "ACGT", *l = "acgt";
    for (int i = 0; i < 4; i++) {
      ENC[(uint8_t)u[i]] = (uint8_t)i;
      ENC[(uint8_t)l[i]] = (uint8_t)i;
    }
  }
} enc_init;

struct Span {
  const uint8_t *p;
  Py_ssize_t n;
};

// Fill one read's composite codes (4-bit, one byte per base, clamped the
// same way numpy's _ENC_PAD0 + np.minimum(codes, 3) does for packing) and
// quals; returns dirty flag.
inline bool encode_one(const Span &s, const Span &q, int edge, uint8_t *codes,
                       int8_t *qv, int32_t *comp_len, int32_t *true_len) {
  const int W = 2 * edge;
  const Py_ssize_t n = s.n;
  *true_len = (int32_t)n;
  const int cl = (int)(n < W ? n : W);
  *comp_len = cl;
  // composite layout: head = s[:edge]; tail = s[edge:W] (short) or
  // s[-edge:] (long); pad rest with code 3 (= what _ENC_PAD0 PAD clamps to)
  bool dirty = false;
  int head = (int)(n < edge ? n : edge);
  for (int i = 0; i < head; i++) {
    uint8_t c = ENC[s.p[i]];
    dirty |= (c == 0xFF);
    codes[i] = c & 3;
  }
  for (int i = head; i < edge; i++) codes[i] = 3;
  const uint8_t *tail_p = s.p + (n <= W ? edge : n - edge);
  int tail = cl - edge;  // < 0 when the read is shorter than edge
  for (int i = 0; i < tail; i++) {
    uint8_t c = ENC[tail_p[i]];
    dirty |= (c == 0xFF);
    codes[edge + i] = c & 3;
  }
  for (int i = (tail > 0 ? tail : 0); i < edge; i++) codes[edge + i] = 3;
  // quals: composite splice of q, phred = max(q-33, 0), 0 beyond the read
  Py_ssize_t qn = q.n;
  int qhead = (int)(qn < edge ? qn : edge);
  for (int i = 0; i < qhead; i++) {
    uint8_t c = q.p[i];
    qv[i] = (int8_t)(c >= 33 ? c - 33 : 0);
  }
  for (int i = qhead; i < edge; i++) qv[i] = 0;
  const uint8_t *qtail_p = q.p + (qn <= W ? edge : qn - edge);
  int qcl = (int)(qn < W ? qn : W);
  int qtail = qcl - edge;
  for (int i = 0; i < qtail; i++) {
    uint8_t c = qtail_p[i];
    qv[edge + i] = (int8_t)(c >= 33 ? c - 33 : 0);
  }
  for (int i = (qtail > 0 ? qtail : 0); i < edge; i++) qv[edge + i] = 0;
  return dirty;
}

inline void pack_2bit(const uint8_t *codes, int W, uint8_t *out) {
  for (int i = 0; i < W / 4; i++) {
    out[i] = (uint8_t)((codes[4 * i] << 6) | (codes[4 * i + 1] << 4) |
                       (codes[4 * i + 2] << 2) | codes[4 * i + 3]);
  }
}

int nthreads_for(Py_ssize_t b) {
  unsigned hw = std::thread::hardware_concurrency();
  int t = hw ? (int)hw : 4;
  if (t > 16) t = 16;
  Py_ssize_t per = 2048;  // don't spawn threads for tiny batches
  int need = (int)((b + per - 1) / per);
  return t < need ? t : (need > 0 ? need : 1);
}

// encode_composite_2bit(seqs: list[bytes], quals: list[bytes], edge: int)
// -> (packed, qv, comp_lens, true_lens, dirty, qsum) as bytes objects:
//    packed [B, edge/2] u8, qv [B, 2*edge] i8, comp/true_lens [B] i32,
//    dirty [B] u8, qsum [B] i32 (sum of the composite quals per read)
PyObject *py_encode_composite_2bit(PyObject *, PyObject *args) {
  PyObject *seqs, *quals;
  int edge;
  if (!PyArg_ParseTuple(args, "OOi", &seqs, &quals, &edge)) return nullptr;
  if (!PyList_Check(seqs) || !PyList_Check(quals)) {
    PyErr_SetString(PyExc_TypeError, "seqs/quals must be lists of bytes");
    return nullptr;
  }
  if (edge <= 0 || edge % 4 != 0) {
    PyErr_SetString(PyExc_ValueError, "edge must be positive multiple of 4");
    return nullptr;
  }
  Py_ssize_t B = PyList_GET_SIZE(seqs);
  if (PyList_GET_SIZE(quals) != B) {
    PyErr_SetString(PyExc_ValueError, "seqs/quals length mismatch");
    return nullptr;
  }
  const int W = 2 * edge, PB = edge / 2;
  std::vector<Span> sp(B), qp(B);
  for (Py_ssize_t i = 0; i < B; i++) {
    PyObject *s = PyList_GET_ITEM(seqs, i);
    PyObject *q = PyList_GET_ITEM(quals, i);
    if (!PyBytes_Check(s) || !PyBytes_Check(q)) {
      PyErr_SetString(PyExc_TypeError, "expected bytes elements");
      return nullptr;
    }
    sp[i] = {(const uint8_t *)PyBytes_AS_STRING(s), PyBytes_GET_SIZE(s)};
    qp[i] = {(const uint8_t *)PyBytes_AS_STRING(q), PyBytes_GET_SIZE(q)};
  }
  PyObject *packed_o = PyByteArray_FromStringAndSize(nullptr, B * PB);
  PyObject *qv_o = PyByteArray_FromStringAndSize(nullptr, (Py_ssize_t)B * W);
  PyObject *cl_o = PyByteArray_FromStringAndSize(nullptr, B * 4);
  PyObject *tl_o = PyByteArray_FromStringAndSize(nullptr, B * 4);
  PyObject *dr_o = PyByteArray_FromStringAndSize(nullptr, B);
  PyObject *qs_o = PyByteArray_FromStringAndSize(nullptr, B * 4);
  if (!packed_o || !qv_o || !cl_o || !tl_o || !dr_o || !qs_o) {
    Py_XDECREF(packed_o); Py_XDECREF(qv_o); Py_XDECREF(cl_o);
    Py_XDECREF(tl_o); Py_XDECREF(dr_o); Py_XDECREF(qs_o);
    return nullptr;
  }
  uint8_t *packed = (uint8_t *)PyByteArray_AS_STRING(packed_o);
  int8_t *qv = (int8_t *)PyByteArray_AS_STRING(qv_o);
  int32_t *cl = (int32_t *)PyByteArray_AS_STRING(cl_o);
  int32_t *tl = (int32_t *)PyByteArray_AS_STRING(tl_o);
  uint8_t *dr = (uint8_t *)PyByteArray_AS_STRING(dr_o);
  int32_t *qs = (int32_t *)PyByteArray_AS_STRING(qs_o);

  Py_BEGIN_ALLOW_THREADS
  int nt = nthreads_for(B);
  auto work = [&](Py_ssize_t lo, Py_ssize_t hi) {
    std::vector<uint8_t> codes(W);
    for (Py_ssize_t i = lo; i < hi; i++) {
      bool d = encode_one(sp[i], qp[i], edge, codes.data(), qv + i * W,
                          cl + i, tl + i);
      dr[i] = d ? 1 : 0;
      pack_2bit(codes.data(), W, packed + i * PB);
      int32_t sum = 0;
      const int8_t *row = qv + i * W;
      for (int k = 0; k < W; k++) sum += row[k];
      qs[i] = sum;
    }
  };
  if (nt <= 1) {
    work(0, B);
  } else {
    std::vector<std::thread> th;
    Py_ssize_t step = (B + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      Py_ssize_t lo = t * step, hi = lo + step < B ? lo + step : B;
      if (lo < hi) th.emplace_back(work, lo, hi);
    }
    for (auto &t : th) t.join();
  }
  Py_END_ALLOW_THREADS

  PyObject *r = PyTuple_Pack(6, packed_o, qv_o, cl_o, tl_o, dr_o, qs_o);
  Py_DECREF(packed_o); Py_DECREF(qv_o); Py_DECREF(cl_o);
  Py_DECREF(tl_o); Py_DECREF(dr_o); Py_DECREF(qs_o);
  return r;
}

// encode_batch(seqs: list[bytes], L: int, pad: int) -> (codes, lens):
// codes [B, L] i8 (A0 C1 G2 T3 N4, pad byte elsewhere), lens [B] i32 —
// native dna.encode_batch for the full-length chimera-scan batches.
PyObject *py_encode_batch(PyObject *, PyObject *args) {
  PyObject *seqs;
  int L, pad;
  if (!PyArg_ParseTuple(args, "Oii", &seqs, &L, &pad)) return nullptr;
  if (!PyList_Check(seqs)) {
    PyErr_SetString(PyExc_TypeError, "seqs must be a list of bytes");
    return nullptr;
  }
  Py_ssize_t B = PyList_GET_SIZE(seqs);
  std::vector<Span> sp(B);
  for (Py_ssize_t i = 0; i < B; i++) {
    PyObject *s = PyList_GET_ITEM(seqs, i);
    if (!PyBytes_Check(s)) {
      PyErr_SetString(PyExc_TypeError, "expected bytes elements");
      return nullptr;
    }
    sp[i] = {(const uint8_t *)PyBytes_AS_STRING(s), PyBytes_GET_SIZE(s)};
  }
  PyObject *codes_o = PyByteArray_FromStringAndSize(nullptr, (Py_ssize_t)B * L);
  PyObject *lens_o = PyByteArray_FromStringAndSize(nullptr, B * 4);
  if (!codes_o || !lens_o) {
    Py_XDECREF(codes_o); Py_XDECREF(lens_o);
    return nullptr;
  }
  int8_t *codes = (int8_t *)PyByteArray_AS_STRING(codes_o);
  int32_t *lens = (int32_t *)PyByteArray_AS_STRING(lens_o);
  Py_BEGIN_ALLOW_THREADS
  int nt = nthreads_for(B);
  auto work = [&](Py_ssize_t lo, Py_ssize_t hi) {
    for (Py_ssize_t i = lo; i < hi; i++) {
      int n = (int)(sp[i].n < L ? sp[i].n : L);
      int8_t *row = codes + i * (Py_ssize_t)L;
      for (int k = 0; k < n; k++) {
        uint8_t c = ENC[sp[i].p[k]];
        row[k] = (int8_t)(c == 0xFF ? 4 : c);  // N_CODE = 4
      }
      memset(row + n, pad, L - n);
      lens[i] = n;
    }
  };
  if (nt <= 1) {
    work(0, B);
  } else {
    std::vector<std::thread> th;
    Py_ssize_t step = (B + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
      Py_ssize_t lo = t * step, hi = lo + step < B ? lo + step : B;
      if (lo < hi) th.emplace_back(work, lo, hi);
    }
    for (auto &t : th) t.join();
  }
  Py_END_ALLOW_THREADS
  PyObject *r = PyTuple_Pack(2, codes_o, lens_o);
  Py_DECREF(codes_o);
  Py_DECREF(lens_o);
  return r;
}


// ---------------------------------------------------------------------------
// emit_records — batch pass-2 fastq record assembly (the per-read Python
// emit loop was ~25% of warm pass-2 wall-clock).  Reproduces
// pipeline/readname.encode_name byte-for-byte (reference read-name
// metadata contract, SURVEY.md).
// ---------------------------------------------------------------------------

uint8_t RC[256];
struct RcInit {
  RcInit() {
    for (int i = 0; i < 256; i++) RC[i] = (uint8_t)i;
    const char *a = "ACGTacgt", *b = "TGCAtgca";
    for (int i = 0; i < 8; i++) RC[(uint8_t)a[i]] = (uint8_t)b[i];
  }
} rc_init;

struct Bufs {
  std::string passed, failed;
};

inline void append_int(std::string &o, long v) {
  // manual itoa: ~4x snprintf("%ld") — ~10 calls/record make this the
  // second-hottest op of the emit loop after the seq copies
  char tmp[24];
  char *p = tmp + 24;
  unsigned long u = v < 0 ? 0UL - (unsigned long)v : (unsigned long)v;
  do { *--p = (char)('0' + (u % 10)); u /= 10; } while (u);
  if (v < 0) *--p = '-';
  o.append(p, (size_t)(tmp + 24 - p));
}

// emit_records(names, comments, seqs, quals: list[bytes],
//   flags u8[B] (bit0 keep, bit1 assigned, bit2 is_fwd),
//   ps, pe, ae, tso, ed, ed2, bc_start, bc_end, rank, x_start, x_end: i32[B],
//   x_qv: f32[B], bc_idx: i32[B], bc_blob: bytes (n_bc * bc_len chars),
//   bc_len: int) -> (passed: bytes, failed: bytes)
PyObject *py_emit_records(PyObject *, PyObject *args) {
  PyObject *names, *comments, *seqs, *quals;
  Py_buffer flags, ps, pe, ae, tso, ed, ed2, bcs, bce, rank, xs, xe, xqv,
      bcidx, bcblob;
  int bc_len;
  if (!PyArg_ParseTuple(args, "OOOOy*y*y*y*y*y*y*y*y*y*y*y*y*y*y*i",
                        &names, &comments, &seqs, &quals, &flags, &ps, &pe,
                        &ae, &tso, &ed, &ed2, &bcs, &bce, &rank, &xs, &xe,
                        &xqv, &bcidx, &bcblob, &bc_len))
    return nullptr;
  Py_ssize_t B = PyList_GET_SIZE(names);
  const uint8_t *fl = (const uint8_t *)flags.buf;
  const int32_t *psv = (const int32_t *)ps.buf;
  const int32_t *pev = (const int32_t *)pe.buf;
  const int32_t *aev = (const int32_t *)ae.buf;
  const int32_t *tsov = (const int32_t *)tso.buf;
  const int32_t *edv = (const int32_t *)ed.buf;
  const int32_t *ed2v = (const int32_t *)ed2.buf;
  const int32_t *bcsv = (const int32_t *)bcs.buf;
  const int32_t *bcev = (const int32_t *)bce.buf;
  const int32_t *rkv = (const int32_t *)rank.buf;
  const int32_t *xsv = (const int32_t *)xs.buf;
  const int32_t *xev = (const int32_t *)xe.buf;
  const float *qvv = (const float *)xqv.buf;
  const int32_t *biv = (const int32_t *)bcidx.buf;
  const char *blob = (const char *)bcblob.buf;
  Py_ssize_t n_bc = bc_len > 0 ? bcblob.len / bc_len : 0;

  int nt = nthreads_for(B);
  std::vector<Bufs> bufs(nt > 0 ? nt : 1);
  std::vector<Span> nmv(B), cmv(B), sqv(B), qlv(B);
  for (Py_ssize_t i = 0; i < B; i++) {
    PyObject *nm = PyList_GET_ITEM(names, i);
    PyObject *cm = PyList_GET_ITEM(comments, i);
    PyObject *sq = PyList_GET_ITEM(seqs, i);
    PyObject *ql = PyList_GET_ITEM(quals, i);
    nmv[i] = {(const uint8_t *)PyBytes_AS_STRING(nm), PyBytes_GET_SIZE(nm)};
    cmv[i] = {(const uint8_t *)PyBytes_AS_STRING(cm), PyBytes_GET_SIZE(cm)};
    sqv[i] = {(const uint8_t *)PyBytes_AS_STRING(sq), PyBytes_GET_SIZE(sq)};
    qlv[i] = {(const uint8_t *)PyBytes_AS_STRING(ql), PyBytes_GET_SIZE(ql)};
  }

  Py_BEGIN_ALLOW_THREADS
  Py_ssize_t step = (B + nt - 1) / nt;
  auto work = [&](int ti, Py_ssize_t lo, Py_ssize_t hi) {
    std::string &pb = bufs[ti].passed;
    std::string &fb = bufs[ti].failed;
    size_t est = 0;
    for (Py_ssize_t i = lo; i < hi; i++)
      est += (size_t)sqv[i].n + qlv[i].n + nmv[i].n + 256;
    pb.reserve(est);
    fb.reserve(est / 4);
    std::string sseq, squal;
    for (Py_ssize_t i = lo; i < hi; i++) {
      if (!(fl[i] & 1)) continue;  // skipped (chimera discard/split)
      const char *nmp = (const char *)nmv[i].p;
      Py_ssize_t nml = nmv[i].n;
      const char *cmp = (const char *)cmv[i].p;
      Py_ssize_t cml = cmv[i].n;
      const char *sp = (const char *)sqv[i].p;
      Py_ssize_t sl = sqv[i].n;
      const char *qp = (const char *)qlv[i].p;
      Py_ssize_t qlen = qlv[i].n;
      if (!(fl[i] & 2)) {  // unassigned -> failed, original orientation
        fb.push_back('@');
        fb.append(nmp, nml);
        if (cml) { fb.push_back(' '); fb.append(cmp, cml); }
        fb.push_back('\n');
        fb.append(sp, sl);
        fb.append("\n+\n", 3);
        fb.append(qp, qlen);
        fb.push_back('\n');
        continue;
      }
      bool fwd = (fl[i] & 4) != 0;
      if (fwd) {
        sseq.assign(sp, sl);
        squal.assign(qp, qlen);
      } else {
        sseq.resize(sl);
        for (Py_ssize_t k = 0; k < sl; k++)
          sseq[k] = (char)RC[(uint8_t)sp[sl - 1 - k]];
        squal.assign(qp, qlen);
        std::reverse(squal.begin(), squal.end());
      }
      // name with scan metadata (readname.encode_name contract)
      pb.push_back('@');
      pb.append(nmp, nml);
      pb.append(fwd ? "_FWD" : "_REV", 4);
      pb.append("_PS=", 4); append_int(pb, psv[i]);
      pb.append("_PE=", 4); append_int(pb, pev[i]);
      pb.append("_AE=", 4); append_int(pb, aev[i]);
      if (tsov[i] >= 0) { pb.append("_T=", 3); append_int(pb, tsov[i]); }
      pb.append("_bc=", 4);
      long bi = biv[i];
      if (bi >= 0 && bi < n_bc) pb.append(blob + bi * bc_len, bc_len);
      pb.append("_ed=", 4); append_int(pb, edv[i]);
      pb.append("_ed_sec=", 8); append_int(pb, ed2v[i]);
      pb.append("_bcStart=", 9); append_int(pb, bcsv[i]);
      pb.append("_bcEnd=", 7); append_int(pb, bcev[i]);
      pb.append("_rk=", 4); append_int(pb, rkv[i]);
      pb.append("_X=", 3);
      long x0 = xsv[i] > 0 ? xsv[i] : 0;
      long x1 = (long)xev[i] + 1;
      if (x1 > (long)sseq.size()) x1 = sseq.size();
      if (x1 > x0) pb.append(sseq.data() + x0, x1 - x0);
      {
        char tmp[32];
        int nq = snprintf(tmp, sizeof tmp, "_Q=%.1f", (double)qvv[i]);
        pb.append(tmp, nq);
      }
      if (cml) { pb.push_back(' '); pb.append(cmp, cml); }
      pb.push_back('\n');
      pb.append(sseq);
      pb.append("\n+\n", 3);
      pb.append(squal);
      pb.push_back('\n');
    }
  };
  if (nt <= 1) {
    work(0, 0, B);
  } else {
    std::vector<std::thread> th;
    for (int t = 0; t < nt; t++) {
      Py_ssize_t lo = t * step, hi = lo + step < B ? lo + step : B;
      if (lo < hi) th.emplace_back(work, t, lo, hi);
    }
    for (auto &t : th) t.join();
  }
  Py_END_ALLOW_THREADS


  size_t pn = 0, fn = 0;
  for (auto &b : bufs) { pn += b.passed.size(); fn += b.failed.size(); }
  PyObject *po = PyBytes_FromStringAndSize(nullptr, pn);
  PyObject *fo = PyBytes_FromStringAndSize(nullptr, fn);
  if (!po || !fo) { Py_XDECREF(po); Py_XDECREF(fo); goto rel; }
  {
    char *pd = PyBytes_AS_STRING(po);
    char *fd = PyBytes_AS_STRING(fo);
    for (auto &b : bufs) {
      memcpy(pd, b.passed.data(), b.passed.size()); pd += b.passed.size();
      memcpy(fd, b.failed.data(), b.failed.size()); fd += b.failed.size();
    }
  }
  {
    PyObject *r = PyTuple_Pack(2, po, fo);
    Py_DECREF(po); Py_DECREF(fo);
    PyBuffer_Release(&flags); PyBuffer_Release(&ps); PyBuffer_Release(&pe);
    PyBuffer_Release(&ae); PyBuffer_Release(&tso); PyBuffer_Release(&ed);
    PyBuffer_Release(&ed2); PyBuffer_Release(&bcs); PyBuffer_Release(&bce);
    PyBuffer_Release(&rank); PyBuffer_Release(&xs); PyBuffer_Release(&xe);
    PyBuffer_Release(&xqv); PyBuffer_Release(&bcidx);
    PyBuffer_Release(&bcblob);
    return r;
  }
rel:
  PyBuffer_Release(&flags); PyBuffer_Release(&ps); PyBuffer_Release(&pe);
  PyBuffer_Release(&ae); PyBuffer_Release(&tso); PyBuffer_Release(&ed);
  PyBuffer_Release(&ed2); PyBuffer_Release(&bcs); PyBuffer_Release(&bce);
  PyBuffer_Release(&rank); PyBuffer_Release(&xs); PyBuffer_Release(&xe);
  PyBuffer_Release(&xqv); PyBuffer_Release(&bcidx);
  PyBuffer_Release(&bcblob);
  return nullptr;
}


// ---------------------------------------------------------------------------
// encode_tiles — internal/chimera-scan tile construction: slice read
// interiors into TILE-base tiles, 2-bases-per-byte nibble codes + meta,
// in one multithreaded pass (the numpy slice+encode+pack path was ~45%
// of warm pass-2 wall-clock).  Layout must match
// models/readscan.build_tiles: rows [T, TILE/2 + 16] u8 with meta
// (own_lo u16, own_hi u16, tlen u16, pad2, g0 u32, rlen u32).
// ---------------------------------------------------------------------------

// encode_tiles(seqs: list[bytes], edge, k, tile, ctx: int) ->
//   (rows, read_idx i32, g0s i32) raw buffers
PyObject *py_encode_tiles(PyObject *, PyObject *args) {
  PyObject *seqs;
  int edge, k, tile, ctx;
  if (!PyArg_ParseTuple(args, "Oiiii", &seqs, &edge, &k, &tile, &ctx))
    return nullptr;
  if (!PyList_Check(seqs)) {
    PyErr_SetString(PyExc_TypeError, "seqs must be a list of bytes");
    return nullptr;
  }
  const int stride = tile - 2 * ctx;
  const long min_len = 2L * edge + k;
  Py_ssize_t B = PyList_GET_SIZE(seqs);
  std::vector<Span> sp(B);
  for (Py_ssize_t i = 0; i < B; i++) {
    PyObject *o = PyList_GET_ITEM(seqs, i);
    if (!PyBytes_Check(o)) {
      PyErr_SetString(PyExc_TypeError, "expected bytes elements");
      return nullptr;
    }
    sp[i] = {(const uint8_t *)PyBytes_AS_STRING(o), PyBytes_GET_SIZE(o)};
  }
  // pass 1: tile counts + per-read first-tile offsets
  std::vector<int64_t> off(B + 1, 0);
  for (Py_ssize_t i = 0; i < B; i++) {
    long L = (long)sp[i].n;
    long cnt = 0;
    if (L > min_len) {
      long lo_g = edge, hi_g = L - edge - k + 1;
      if (hi_g > lo_g) {
        for (long t = 0;; t++) {
          long own_start = t == 0 ? 0 : t * (long)stride + ctx;
          if (own_start >= hi_g) break;
          long own_end = ctx + (t + 1) * (long)stride;
          long ol = own_start > lo_g ? own_start : lo_g;
          long oh = own_end < hi_g ? own_end : hi_g;
          if (ol < oh) cnt++;
        }
      }
    }
    off[i + 1] = off[i] + cnt;
  }
  const int64_t T = off[B];
  const int rowb = tile / 2 + 16;
  PyObject *rows_o = PyByteArray_FromStringAndSize(nullptr, T * rowb);
  PyObject *ri_o = PyByteArray_FromStringAndSize(nullptr, T * 4);
  PyObject *g0_o = PyByteArray_FromStringAndSize(nullptr, T * 4);
  if (!rows_o || !ri_o || !g0_o) {
    Py_XDECREF(rows_o); Py_XDECREF(ri_o); Py_XDECREF(g0_o);
    return nullptr;
  }
  uint8_t *rows = (uint8_t *)PyByteArray_AS_STRING(rows_o);
  int32_t *ri = (int32_t *)PyByteArray_AS_STRING(ri_o);
  int32_t *g0s = (int32_t *)PyByteArray_AS_STRING(g0_o);

  Py_BEGIN_ALLOW_THREADS
  int nt = nthreads_for(B);
  std::vector<std::thread> th;
  Py_ssize_t step = (B + nt - 1) / nt;
  auto work = [&](Py_ssize_t lo, Py_ssize_t hi) {
    for (Py_ssize_t i = lo; i < hi; i++) {
      long L = (long)sp[i].n;
      if (off[i] == off[i + 1]) continue;
      long lo_g = edge, hi_g = L - edge - k + 1;
      int64_t w = off[i];
      for (long t = 0;; t++) {
        long own_start = t == 0 ? 0 : t * (long)stride + ctx;
        if (own_start >= hi_g) break;
        long own_end = ctx + (t + 1) * (long)stride;
        long ol = own_start > lo_g ? own_start : lo_g;
        long oh = own_end < hi_g ? own_end : hi_g;
        if (ol >= oh) continue;
        long g0 = t * (long)stride;
        long tlen = L - g0 < tile ? L - g0 : tile;
        uint8_t *row = rows + w * rowb;
        const uint8_t *src = sp[i].p + g0;
        // nibble codes, PAD (5) beyond tlen; N -> 4
        long j = 0;
        for (; j + 1 < tlen; j += 2) {
          uint8_t a = ENC[src[j]], b = ENC[src[j + 1]];
          a = a == 0xFF ? 4 : a;
          b = b == 0xFF ? 4 : b;
          row[j >> 1] = (uint8_t)((a << 4) | b);
        }
        if (j < tlen) {
          uint8_t a = ENC[src[j]];
          a = a == 0xFF ? 4 : a;
          row[j >> 1] = (uint8_t)((a << 4) | 5);
          j += 2;
        }
        for (; j < tile; j += 2) row[j >> 1] = 0x55;  // PAD|PAD
        uint8_t *mv = row + tile / 2;
        long own_lo = ol - g0, own_hi = oh - g0;
        mv[0] = own_lo & 0xFF; mv[1] = (own_lo >> 8) & 0xFF;
        mv[2] = own_hi & 0xFF; mv[3] = (own_hi >> 8) & 0xFF;
        mv[4] = tlen & 0xFF;  mv[5] = (tlen >> 8) & 0xFF;
        mv[6] = 0; mv[7] = 0;
        uint32_t g32 = (uint32_t)g0, r32 = (uint32_t)L;
        memcpy(mv + 8, &g32, 4);
        memcpy(mv + 12, &r32, 4);
        ri[w] = (int32_t)i;
        g0s[w] = (int32_t)g0;
        w++;
      }
    }
  };
  if (nt <= 1) {
    work(0, B);
  } else {
    for (int t = 0; t < nt; t++) {
      Py_ssize_t lo = t * step, hi = lo + step < B ? lo + step : B;
      if (lo < hi) th.emplace_back(work, lo, hi);
    }
    for (auto &t : th) t.join();
  }
  Py_END_ALLOW_THREADS

  PyObject *r = PyTuple_Pack(3, rows_o, ri_o, g0_o);
  Py_DECREF(rows_o); Py_DECREF(ri_o); Py_DECREF(g0_o);
  return r;
}

// encode_composite_tm(seqs, quals, edge) -> (packed_tm, qv2, true_lens,
// dirty, qsum): the round-4 TWO-HALF TEXT-MAJOR layout (ops.edgescan).
//   packed_tm [2*edge/4 + 4, B] u8 — row r holds bases 4r..4r+3 of every
//     read's composite (head left-aligned cols [0,edge), tail RIGHT-aligned
//     cols [edge,2*edge)); the last 4 rows are little-endian true lengths
//   qv2 [B, 2*edge] i8 quals in the same two-half layout
//   qsum — sum of quals over the min(L, 2*edge) distinct covered positions
// Byte-identical to edgescan.encode_composite_tm's numpy fallback
// (tests/test_readscan.py::test_native_encode_tm_matches_numpy).
PyObject *py_encode_composite_tm(PyObject *, PyObject *args) {
  PyObject *seqs, *quals;
  int edge;
  if (!PyArg_ParseTuple(args, "OOi", &seqs, &quals, &edge)) return nullptr;
  if (!PyList_Check(seqs) || !PyList_Check(quals)) {
    PyErr_SetString(PyExc_TypeError, "seqs/quals must be lists of bytes");
    return nullptr;
  }
  if (edge <= 0 || edge % 4 != 0) {
    PyErr_SetString(PyExc_ValueError, "edge must be positive multiple of 4");
    return nullptr;
  }
  Py_ssize_t B = PyList_GET_SIZE(seqs);
  if (PyList_GET_SIZE(quals) != B) {
    PyErr_SetString(PyExc_ValueError, "seqs/quals length mismatch");
    return nullptr;
  }
  const int W = 2 * edge;
  const int TEXT_ROWS = W / 4, PACK_ROWS = TEXT_ROWS + 4;
  std::vector<Span> sp(B), qp(B);
  for (Py_ssize_t i = 0; i < B; i++) {
    PyObject *s = PyList_GET_ITEM(seqs, i);
    PyObject *q = PyList_GET_ITEM(quals, i);
    if (!PyBytes_Check(s) || !PyBytes_Check(q)) {
      PyErr_SetString(PyExc_TypeError, "expected bytes elements");
      return nullptr;
    }
    sp[i] = {(const uint8_t *)PyBytes_AS_STRING(s), PyBytes_GET_SIZE(s)};
    qp[i] = {(const uint8_t *)PyBytes_AS_STRING(q), PyBytes_GET_SIZE(q)};
  }
  PyObject *packed_o =
      PyByteArray_FromStringAndSize(nullptr, (Py_ssize_t)PACK_ROWS * B);
  PyObject *qv_o = PyByteArray_FromStringAndSize(nullptr, (Py_ssize_t)B * W);
  PyObject *tl_o = PyByteArray_FromStringAndSize(nullptr, B * 4);
  PyObject *dr_o = PyByteArray_FromStringAndSize(nullptr, B);
  PyObject *qs_o = PyByteArray_FromStringAndSize(nullptr, B * 4);
  if (!packed_o || !qv_o || !tl_o || !dr_o || !qs_o) {
    Py_XDECREF(packed_o); Py_XDECREF(qv_o); Py_XDECREF(tl_o);
    Py_XDECREF(dr_o); Py_XDECREF(qs_o);
    return nullptr;
  }
  uint8_t *packed = (uint8_t *)PyByteArray_AS_STRING(packed_o);
  int8_t *qv = (int8_t *)PyByteArray_AS_STRING(qv_o);
  int32_t *tl = (int32_t *)PyByteArray_AS_STRING(tl_o);
  uint8_t *dr = (uint8_t *)PyByteArray_AS_STRING(dr_o);
  int32_t *qs = (int32_t *)PyByteArray_AS_STRING(qs_o);

  Py_BEGIN_ALLOW_THREADS
  int nt = nthreads_for(B);
  // threads own COLUMN BLOCKS of reads and encode into an L2-resident
  // [PACK_ROWS, TB] tile, then memcpy rows out — the text-major global
  // writes stay sequential per row
  const Py_ssize_t TB = 256;
  std::vector<Py_ssize_t> blocks;
  for (Py_ssize_t b0 = 0; b0 < B; b0 += TB) blocks.push_back(b0);
  std::atomic<size_t> next(0);
  auto work = [&]() {
    std::vector<uint8_t> codes(W);
    std::vector<uint8_t> tile((size_t)PACK_ROWS * TB);
    size_t bi;
    while ((bi = next.fetch_add(1)) < blocks.size()) {
      Py_ssize_t lo = blocks[bi];
      Py_ssize_t hi = lo + TB < B ? lo + TB : B;
      Py_ssize_t tb = hi - lo;
      for (Py_ssize_t i = lo; i < hi; i++) {
        const Py_ssize_t n = sp[i].n;
        const int hl = (int)(n < edge ? n : edge);
        bool dirty = false;
        // head left-aligned
        for (int k = 0; k < hl; k++) {
          uint8_t c = ENC[sp[i].p[k]];
          dirty |= (c == 0xFF);
          codes[k] = c & 3;
        }
        for (int k = hl; k < edge; k++) codes[k] = 3;
        // tail right-aligned (last hl bases end at column W-1)
        for (int k = edge; k < W - hl; k++) codes[k] = 3;
        const uint8_t *tp = sp[i].p + n - hl;
        for (int k = 0; k < hl; k++) {
          uint8_t c = ENC[tp[k]];
          dirty |= (c == 0xFF);
          codes[W - hl + k] = c & 3;
        }
        dr[i] = dirty ? 1 : 0;
        tl[i] = (int32_t)n;
        // pack text-major into the tile (stride tb per row)
        uint8_t *col = tile.data() + (i - lo);
        for (int r0 = 0; r0 < TEXT_ROWS; r0++) {
          col[(size_t)r0 * tb] =
              (uint8_t)((codes[4 * r0] << 6) | (codes[4 * r0 + 1] << 4) |
                        (codes[4 * r0 + 2] << 2) | codes[4 * r0 + 3]);
        }
        uint32_t un = (uint32_t)n;
        for (int r0 = 0; r0 < 4; r0++)
          col[(size_t)(TEXT_ROWS + r0) * tb] = (uint8_t)(un >> (8 * r0));
        // quals (row-major out) + qsum
        int8_t *qrow = qv + (size_t)i * W;
        const Py_ssize_t qn = qp[i].n;
        const int qhl = (int)(qn < edge ? qn : edge);
        int32_t sum = 0;
        for (int k = 0; k < qhl; k++) {
          uint8_t c = qp[i].p[k];
          int8_t v = (int8_t)(c >= 33 ? c - 33 : 0);
          qrow[k] = v;
          sum += v;
        }
        for (int k = qhl; k < edge; k++) qrow[k] = 0;
        for (int k = edge; k < W - qhl; k++) qrow[k] = 0;
        const uint8_t *qt = qp[i].p + qn - qhl;
        for (int k = 0; k < qhl; k++) {
          uint8_t c = qt[k];
          qrow[W - qhl + k] = (int8_t)(c >= 33 ? c - 33 : 0);
        }
        // qsum: head + non-overlapping tail positions (true coords >= the
        // larger of edge and L-edge)
        Py_ssize_t start2 = (Py_ssize_t)edge;
        if (qn - edge > start2) start2 = qn - edge;
        for (Py_ssize_t k2 = start2; k2 < qn; k2++) {
          uint8_t c = qp[i].p[k2];
          sum += (c >= 33 ? c - 33 : 0);
        }
        qs[i] = sum;
      }
      for (int r0 = 0; r0 < PACK_ROWS; r0++)
        memcpy(packed + (size_t)r0 * B + lo, tile.data() + (size_t)r0 * tb,
               (size_t)tb);
    }
  };
  std::vector<std::thread> th;
  for (int t = 0; t < nt; t++) th.emplace_back(work);
  for (auto &t : th) t.join();
  Py_END_ALLOW_THREADS

  PyObject *r = PyTuple_Pack(5, packed_o, qv_o, tl_o, dr_o, qs_o);
  Py_DECREF(packed_o); Py_DECREF(qv_o); Py_DECREF(tl_o);
  Py_DECREF(dr_o); Py_DECREF(qs_o);
  return r;
}

// transpose_u8(src: bytes-like [T, R] row-major, T, R, Tp) -> bytes
// [R, Tp] with columns T..Tp-1 zero — the text-major tile-row stack for
// the Pallas tile-scan kernel (numpy's strided transpose of the same
// costs ~10-20 ms per chunk).
PyObject *py_transpose_u8(PyObject *, PyObject *args) {
  Py_buffer src;
  Py_ssize_t T, R, Tp;
  if (!PyArg_ParseTuple(args, "y*nnn", &src, &T, &R, &Tp)) return nullptr;
  if (src.len < T * R || Tp < T) {
    PyBuffer_Release(&src);
    PyErr_SetString(PyExc_ValueError, "bad transpose dims");
    return nullptr;
  }
  PyObject *out_o = PyByteArray_FromStringAndSize(nullptr, R * Tp);
  if (!out_o) { PyBuffer_Release(&src); return nullptr; }
  uint8_t *out = (uint8_t *)PyByteArray_AS_STRING(out_o);
  const uint8_t *in = (const uint8_t *)src.buf;
  Py_BEGIN_ALLOW_THREADS
  memset(out, 0, (size_t)R * Tp);
  const Py_ssize_t BT = 64;  // cache-blocked
  int nt = nthreads_for(T);
  std::atomic<Py_ssize_t> next(0);
  auto work = [&]() {
    Py_ssize_t t0;
    while ((t0 = next.fetch_add(BT)) < T) {
      Py_ssize_t t1 = t0 + BT < T ? t0 + BT : T;
      for (Py_ssize_t r0 = 0; r0 < R; r0 += BT) {
        Py_ssize_t r1 = r0 + BT < R ? r0 + BT : R;
        for (Py_ssize_t t = t0; t < t1; t++)
          for (Py_ssize_t r = r0; r < r1; r++)
            out[r * Tp + t] = in[t * R + r];
      }
    }
  };
  std::vector<std::thread> th;
  for (int t = 0; t < nt; t++) th.emplace_back(work);
  for (auto &t : th) t.join();
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&src);
  return out_o;
}


// ---------------------------------------------------------------------------
// window_qv_means — per-read mean phred over [s, e] windows of the
// two-half composite qual matrix (head E cols = true coords 0..E-1, tail
// E cols = true coords L-E..L-1).  The numpy gather formulation cost
// ~20-80 ms per 32k-read chunk; this is one multithreaded pass.
// ---------------------------------------------------------------------------

// window_qv_means(qv2: buffer i8 [B, 2E], B, E, lens i64[B], s i64[B],
//   e i64[B]) -> f32[B] bytes
PyObject *py_window_qv_means(PyObject *, PyObject *args) {
  Py_buffer qv2, lens, sb, eb;
  Py_ssize_t B, E;
  if (!PyArg_ParseTuple(args, "y*nny*y*y*", &qv2, &B, &E, &lens, &sb, &eb))
    return nullptr;
  const Py_ssize_t L2 = 2 * E;
  if (qv2.len < B * L2 || lens.len < B * 8 || sb.len < B * 8 ||
      eb.len < B * 8) {
    PyBuffer_Release(&qv2); PyBuffer_Release(&lens);
    PyBuffer_Release(&sb); PyBuffer_Release(&eb);
    PyErr_SetString(PyExc_ValueError, "bad window_qv_means dims");
    return nullptr;
  }
  PyObject *out_o = PyByteArray_FromStringAndSize(nullptr, B * 4);
  if (!out_o) {
    PyBuffer_Release(&qv2); PyBuffer_Release(&lens);
    PyBuffer_Release(&sb); PyBuffer_Release(&eb);
    return nullptr;
  }
  float *out = (float *)PyByteArray_AS_STRING(out_o);
  const int8_t *qv = (const int8_t *)qv2.buf;
  const int64_t *ln = (const int64_t *)lens.buf;
  const int64_t *ss = (const int64_t *)sb.buf;
  const int64_t *ee = (const int64_t *)eb.buf;
  Py_BEGIN_ALLOW_THREADS
  int nt = nthreads_for(B);
  std::vector<std::thread> th;
  Py_ssize_t step = (B + nt - 1) / nt;
  auto work = [&](Py_ssize_t lo, Py_ssize_t hi) {
    for (Py_ssize_t i = lo; i < hi; i++) {
      int64_t L = ln[i];
      int64_t s = ss[i] < 0 ? 0 : ss[i];
      int64_t e1 = ee[i] + 1 < L ? ee[i] + 1 : L;
      int64_t n = e1 - s;
      if (n < 1) n = 1;
      long sum = 0;
      const int8_t *row = qv + i * L2;
      for (int64_t q = s; q < e1; q++) {
        int64_t col = q < E ? q : q - L + L2;
        if (col < 0) col = 0;
        if (col > L2 - 1) col = L2 - 1;
        sum += row[col];
      }
      out[i] = (float)sum / (float)n;
    }
  };
  for (int t = 0; t < nt; t++) {
    Py_ssize_t lo = t * step, hi = lo + step < B ? lo + step : B;
    if (lo < hi) th.emplace_back(work, lo, hi);
  }
  for (auto &t : th) t.join();
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&qv2); PyBuffer_Release(&lens);
  PyBuffer_Release(&sb); PyBuffer_Release(&eb);
  return out_o;
}


// ---------------------------------------------------------------------------
// parse_fastq — split a fastq byte block into (names, comments, seqs,
// quals, consumed): one C pass creating exactly 4 PyBytes per record.
// The Python block parser (split + per-record endswith/startswith +
// list plumbing) was ~0.34 s per 32k-read warm e2e.
// ---------------------------------------------------------------------------

static inline Py_ssize_t rstrip_cr(const char *p, Py_ssize_t n) {
  return (n > 0 && p[n - 1] == '\r') ? n - 1 : n;
}

// parse_fastq(data: bytes) -> (names, comments, seqs, quals, consumed)
PyObject *py_parse_fastq(PyObject *, PyObject *args) {
  Py_buffer data;
  if (!PyArg_ParseTuple(args, "y*", &data)) return nullptr;
  const char *buf = (const char *)data.buf;
  const Py_ssize_t n = data.len;
  PyObject *names = PyList_New(0), *comments = PyList_New(0);
  PyObject *seqs = PyList_New(0), *quals = PyList_New(0);
  if (!names || !comments || !seqs || !quals) {
    Py_XDECREF(names); Py_XDECREF(comments);
    Py_XDECREF(seqs); Py_XDECREF(quals);
    PyBuffer_Release(&data);
    return nullptr;
  }
  Py_ssize_t pos = 0, consumed = 0;
  while (pos < n) {
    // locate 4 newline-terminated lines from pos
    const char *l[4]; Py_ssize_t ll[4];
    Py_ssize_t p = pos; int ok = 1;
    for (int i = 0; i < 4; i++) {
      const char *nl = (const char *)memchr(buf + p, '\n', n - p);
      if (!nl) { ok = 0; break; }
      l[i] = buf + p;
      ll[i] = rstrip_cr(buf + p, nl - (buf + p));
      p = (nl - buf) + 1;
    }
    if (!ok) break;
    if (ll[0] < 1 || l[0][0] != '@') {
      PyErr_Format(PyExc_ValueError, "malformed fastq header: %.60s",
                   l[0]);
      goto fail;
    }
    {
      const char *sp = (const char *)memchr(l[0], ' ', ll[0]);
      PyObject *nm, *cm;
      if (sp) {
        nm = PyBytes_FromStringAndSize(l[0] + 1, sp - l[0] - 1);
        cm = PyBytes_FromStringAndSize(sp + 1, l[0] + ll[0] - sp - 1);
      } else {
        nm = PyBytes_FromStringAndSize(l[0] + 1, ll[0] - 1);
        cm = PyBytes_FromStringAndSize(nullptr, 0);
      }
      PyObject *sq = PyBytes_FromStringAndSize(l[1], ll[1]);
      PyObject *qu = PyBytes_FromStringAndSize(l[3], ll[3]);
      if (!nm || !cm || !sq || !qu ||
          PyList_Append(names, nm) || PyList_Append(comments, cm) ||
          PyList_Append(seqs, sq) || PyList_Append(quals, qu)) {
        Py_XDECREF(nm); Py_XDECREF(cm); Py_XDECREF(sq); Py_XDECREF(qu);
        goto fail;
      }
      Py_DECREF(nm); Py_DECREF(cm); Py_DECREF(sq); Py_DECREF(qu);
    }
    pos = p;
    consumed = p;
  }
  PyBuffer_Release(&data);
  {
    PyObject *r = Py_BuildValue("(OOOOn)", names, comments, seqs, quals,
                                consumed);
    Py_DECREF(names); Py_DECREF(comments);
    Py_DECREF(seqs); Py_DECREF(quals);
    return r;
  }
fail:
  Py_DECREF(names); Py_DECREF(comments);
  Py_DECREF(seqs); Py_DECREF(quals);
  PyBuffer_Release(&data);
  return nullptr;
}


// ---------------------------------------------------------------------------
// chain_dp — minimap2-style splice-tolerant anchor chain DP (the inner
// per-read Python loop in align/chain.py was the aligner's scaling
// bottleneck). Sequential in anchors, C-speed; the
// traceback + second-best stay vectorized numpy in the caller.
// ---------------------------------------------------------------------------

// chain_dp(q i64[n], g i64[n], n, k, window, max_intron) ->
//   (f f32[n], parent i32[n])
PyObject *py_chain_dp(PyObject *, PyObject *args) {
  Py_buffer qb, gb;
  Py_ssize_t n, k, win, max_intron;
  if (!PyArg_ParseTuple(args, "y*y*nnnn", &qb, &gb, &n, &k, &win,
                        &max_intron))
    return nullptr;
  if (qb.len < n * 8 || gb.len < n * 8) {
    PyBuffer_Release(&qb); PyBuffer_Release(&gb);
    PyErr_SetString(PyExc_ValueError, "bad chain_dp dims");
    return nullptr;
  }
  PyObject *f_o = PyByteArray_FromStringAndSize(nullptr, n * 4);
  PyObject *p_o = PyByteArray_FromStringAndSize(nullptr, n * 4);
  if (!f_o || !p_o) {
    Py_XDECREF(f_o); Py_XDECREF(p_o);
    PyBuffer_Release(&qb); PyBuffer_Release(&gb);
    return nullptr;
  }
  float *f = (float *)PyByteArray_AS_STRING(f_o);
  int32_t *parent = (int32_t *)PyByteArray_AS_STRING(p_o);
  const int64_t *q = (const int64_t *)qb.buf;
  const int64_t *g = (const int64_t *)gb.buf;
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < n; i++) {
    f[i] = (float)k;
    parent[i] = -1;
    Py_ssize_t j0 = i - win > 0 ? i - win : 0;
    float bestv = -1e18f; Py_ssize_t bestj = -1;
    for (Py_ssize_t j = j0; j < i; j++) {
      int64_t dq = q[i] - q[j], dg = g[i] - g[j];
      if (dq <= 0 || dg <= 0 || dg >= max_intron) continue;
      int64_t gap = dg - dq; if (gap < 0) gap = -gap;
      float cost = gap < 64 ? 0.5f * (float)gap
                            : 16.0f + 2.0f * log2f((float)gap);
      int64_t match = dq < dg ? dq : dg;
      if (match > k) match = k;
      float cand = f[j] + (float)match - cost;
      if (cand > bestv) { bestv = cand; bestj = j; }
    }
    if (bestj >= 0 && bestv > f[i]) {
      f[i] = bestv;
      parent[i] = (int32_t)bestj;
    }
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&qb); PyBuffer_Release(&gb);
  PyObject *r = PyTuple_Pack(2, f_o, p_o);
  Py_DECREF(f_o); Py_DECREF(p_o);
  return r;
}


// ---------------------------------------------------------------------------
// build_minimizers — minimap2-style minimizer sketch of one contig
// (canonical k-mer min-hash over w-windows), exactly matching
// align/index.minimizers: invertible murmur-style finalizer, first-index
// tie-breaking, consecutive-duplicate dedupe, N-window invalidation.
// The numpy build capped the index at ~100 Mb references; this is
// single-pass C with
// a monotonic deque, GIL released (callers thread across contigs).
// ---------------------------------------------------------------------------

static inline uint64_t mix64(uint64_t h) {
  h = ~h + (h << 21);
  h = h ^ (h >> 24);
  h = h + (h << 3) + (h << 8);
  h = h ^ (h >> 14);
  h = h + (h << 2) + (h << 4);
  h = h ^ (h >> 28);
  h = h + (h << 31);
  return h;
}

// build_minimizers(seq: bytes, k, w) -> (hash u64[m], pos u32[m],
//   strand u8[m])
PyObject *py_build_minimizers(PyObject *, PyObject *args) {
  Py_buffer sb;
  Py_ssize_t k, w;
  if (!PyArg_ParseTuple(args, "y*nn", &sb, &k, &w)) return nullptr;
  const uint8_t *seq = (const uint8_t *)sb.buf;
  const Py_ssize_t L = sb.len;
  const Py_ssize_t n = L - k + 1;
  std::vector<uint64_t> hs;
  std::vector<uint32_t> ps;
  std::vector<uint8_t> ss;
  if (n >= w) {
    Py_BEGIN_ALLOW_THREADS
    const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    const uint64_t INVALID = 0xFFFFFFFFFFFFFFFFULL;
    // rolling forward/revcomp codes + per-window hash, streamed through
    // a monotonic deque (front = argmin with first-index ties)
    std::vector<uint64_t> hbuf(n);
    std::vector<uint8_t> rcbuf(n);
    uint64_t fwd = 0, rev = 0;
    Py_ssize_t bad_run = 0;
    for (Py_ssize_t i = 0; i < L; i++) {
      uint8_t c = ENC[seq[i]];
      uint8_t cc = c > 3 ? 0 : c;
      bad_run = c > 3 ? 0 : bad_run + 1;  // valid-suffix length
      fwd = ((fwd << 2) | cc) & mask;
      rev = (rev >> 2) | ((uint64_t)(3 ^ cc) << (2 * (k - 1)));
      if (i >= k - 1) {
        Py_ssize_t p = i - (k - 1);
        if (bad_run >= k) {
          uint8_t rc = rev < fwd;
          hbuf[p] = mix64(rc ? rev : fwd);
          rcbuf[p] = rc;
        } else {
          hbuf[p] = INVALID;
          rcbuf[p] = 0;
        }
      }
    }
    std::vector<Py_ssize_t> dq(n);
    Py_ssize_t qh = 0, qt = 0;  // deque [qh, qt)
    Py_ssize_t last_pos = -1;
    for (Py_ssize_t i = 0; i < n; i++) {
      while (qt > qh && hbuf[dq[qt - 1]] > hbuf[i]) qt--;
      dq[qt++] = i;
      if (dq[qh] <= i - w) qh++;
      if (i >= w - 1) {
        Py_ssize_t p = dq[qh];
        if (p != last_pos && hbuf[p] != INVALID) {
          hs.push_back(hbuf[p]);
          ps.push_back((uint32_t)p);
          ss.push_back(rcbuf[p]);
          last_pos = p;
        } else if (p != last_pos) {
          last_pos = p;  // invalid minimizer: numpy path also skips it
        }
      }
    }
    Py_END_ALLOW_THREADS
  }
  const Py_ssize_t m = (Py_ssize_t)hs.size();
  PyObject *h_o = PyByteArray_FromStringAndSize(
      (const char *)hs.data(), m * 8);
  PyObject *p_o = PyByteArray_FromStringAndSize(
      (const char *)ps.data(), m * 4);
  PyObject *s_o = PyByteArray_FromStringAndSize(
      (const char *)ss.data(), m);
  PyBuffer_Release(&sb);
  if (!h_o || !p_o || !s_o) {
    Py_XDECREF(h_o); Py_XDECREF(p_o); Py_XDECREF(s_o);
    return nullptr;
  }
  PyObject *r = PyTuple_Pack(3, h_o, p_o, s_o);
  Py_DECREF(h_o); Py_DECREF(p_o); Py_DECREF(s_o);
  return r;
}

PyMethodDef methods[] = {
    {"transpose_u8", py_transpose_u8, METH_VARARGS,
     "[T, R] u8 row-major -> [R, Tp] text-major (zero-padded columns)"},
    {"window_qv_means", py_window_qv_means, METH_VARARGS,
     "mean phred over [s,e] windows of the two-half composite quals"},
    {"parse_fastq", py_parse_fastq, METH_VARARGS,
     "fastq block -> (names, comments, seqs, quals, consumed bytes)"},
    {"chain_dp", py_chain_dp, METH_VARARGS,
     "splice-tolerant anchor chain DP -> (scores f32, parents i32)"},
    {"build_minimizers", py_build_minimizers, METH_VARARGS,
     "contig bytes -> (minimizer hashes u64, positions u32, strands u8)"},
    {"encode_composite_tm", py_encode_composite_tm, METH_VARARGS,
     "fastq chunk -> round-4 two-half text-major packed composite"},
    {"encode_composite_2bit", py_encode_composite_2bit, METH_VARARGS,
     "fastq chunk -> (packed 2-bit composite, qv, comp_lens, true_lens, "
     "dirty, qsum) raw-bytes buffers"},
    {"encode_batch", py_encode_batch, METH_VARARGS,
     "list[bytes] -> ([B, L] int8 code matrix, lens int32) raw buffers"},
    {"encode_tiles", py_encode_tiles, METH_VARARGS,
     "internal-scan tile rows (nibble codes + meta) from a read list"},
    {"emit_records", py_emit_records, METH_VARARGS,
     "batch pass-2 fastq record assembly -> (passed, failed) bytes"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moddef = {PyModuleDef_HEAD_INIT, "sicelore_hostenc",
                             "native host-side fastq encode kernels", -1,
                             methods};

}  // namespace

PyMODINIT_FUNC PyInit_sicelore_hostenc(void) {
  return PyModule_Create(&moddef);
}
