"""Synthetic 10x-3' Nanopore read generator (test/bench fixture).

Plays the role the reference's Bulk2FakeSingleCell program plays as a
synthetic-data source (/root/reference: programs/Bulk2FakeSingleCell.java —
constant BC + random UMIs), extended to emit full library-structure reads:

  stranded (FWD) layout:  TSO . cDNA . polyA . rc(UMI) . rc(BC) . rc(adapter)
  REV reads are the reverse complement of the whole molecule.

Error injection is uniform sub/ins/del at a configurable rate so edit-
distance paths and negative controls are exercisable.
"""
from __future__ import annotations

import numpy as np

from sicelore_tpu.utils import dna

ADAPTER = "CTACACGACGCTCTTCCGATCT"   # complete 10x R1 adapter (config.xml:112-114)
TSO = "AACGCAGAGTACATGG"             # config.xml:158


def random_seq(rng: np.random.Generator, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def mutate(rng: np.random.Generator, seq: str, rate: float) -> str:
    """Uniform substitution/insertion/deletion noise."""
    if rate <= 0:
        return seq
    out = []
    for ch in seq:
        r = rng.random()
        if r < rate:
            kind = rng.integers(0, 3)
            if kind == 0:      # substitution
                out.append("ACGT"[rng.integers(0, 4)])
            elif kind == 1:    # insertion
                out.append(ch)
                out.append("ACGT"[rng.integers(0, 4)])
            # kind == 2: deletion (skip)
        else:
            out.append(ch)
    return "".join(out)


def make_whitelist(rng: np.random.Generator, n: int, bc_len: int = 16) -> list[str]:
    seen, out = set(), []
    while len(out) < n:
        bc = random_seq(rng, bc_len)
        if bc not in seen:
            seen.add(bc)
            out.append(bc)
    return out


def make_read(rng: np.random.Generator, bc: str, umi: str | None = None,
              cdna_len: int = 400, polya_len: int = 20, error_rate: float = 0.0,
              reverse: bool = False, with_tso: bool = True,
              qual_char: str = "I") -> dict:
    """Build one read; returns dict(name-parts, seq, qual, truth fields)."""
    umi = umi if umi is not None else random_seq(rng, 12)
    cdna = random_seq(rng, cdna_len)
    stranded = (
        (TSO if with_tso else "") + cdna + "A" * polya_len
        + dna.revcomp_str(umi) + dna.revcomp_str(bc) + dna.revcomp_str(ADAPTER)
    )
    stranded = mutate(rng, stranded, error_rate)
    seq = dna.revcomp_str(stranded) if reverse else stranded
    return {
        "seq": seq.encode(),
        "qual": (qual_char * len(seq)).encode(),
        "bc": bc, "umi": umi, "reverse": reverse,
        "polya_len": polya_len, "cdna_len": cdna_len,
    }


def make_read_5p(rng: np.random.Generator, bc: str, umi: str | None = None,
                 cdna_len: int = 400, polya_len: int = 20,
                 error_rate: float = 0.0, reverse: bool = False,
                 qual_char: str = "I") -> dict:
    """5' chemistry read: ADAPTER BC UMI TSO cDNA polyA rc(3'adapter)
    (config.xml:120-185)."""
    umi = umi if umi is not None else random_seq(rng, 12)
    cdna = random_seq(rng, cdna_len)
    stranded = (ADAPTER + bc + umi + TSO + cdna + "A" * polya_len
                + dna.revcomp_str("AAGCAGTGGTATCAACGCAGAGTAC"))
    stranded = mutate(rng, stranded, error_rate)
    seq = dna.revcomp_str(stranded) if reverse else stranded
    return {"seq": seq.encode(), "qual": (qual_char * len(seq)).encode(),
            "bc": bc, "umi": umi, "reverse": reverse}


def make_chimera(rng: np.random.Generator, bc1: str, bc2: str, **kw) -> dict:
    """Two molecules fused head-to-tail (split-candidate fixture)."""
    r1 = make_read(rng, bc1, reverse=False, **kw)
    r2 = make_read(rng, bc2, reverse=False, **kw)
    return {"seq": r1["seq"] + r2["seq"], "qual": r1["qual"] + r2["qual"],
            "bc": (bc1, bc2)}


def reads_to_batch(reads: list[dict], max_len: int | None = None):
    """Encode read dicts -> (seqs [B, L] int8, quals [B, L] int8, lens [B])."""
    seqs, lens = dna.encode_batch([r["seq"] for r in reads], max_len)
    L = seqs.shape[1]
    quals = np.zeros((len(reads), L), dtype=np.int8)
    for i, r in enumerate(reads):
        q = dna.phred_to_qual(r["qual"])[:L]
        quals[i, :len(q)] = q
    return seqs, quals, lens


# ---------------------------------------------------------------------------
# Vectorized generators for benchmark-scale datasets (same read layout and
# event model as make_read / mutate, drawn from another random stream)
# ---------------------------------------------------------------------------

_ACGT_U8 = np.frombuffer(b"ACGT", np.uint8)
_RC_TABLE = bytes.maketrans(b"ACGT", b"TGCA")


def random_bytes(rng: np.random.Generator, n: int) -> bytes:
    return _ACGT_U8[rng.integers(0, 4, n)].tobytes()


def revcomp_bytes(seq: bytes) -> bytes:
    return seq.translate(_RC_TABLE)[::-1]


def mutate_fast(rng: np.random.Generator, seq: bytes, rate: float) -> bytes:
    """Per base, with probability `rate`, one of substitution, insertion
    after the base, or deletion (equally likely) — `mutate`'s model."""
    a = np.frombuffer(seq, np.uint8)
    n = len(a)
    ev = rng.random(n) < rate
    kind = rng.integers(0, 3, n)
    sub = _ACGT_U8[rng.integers(0, 4, n)]
    extra = _ACGT_U8[rng.integers(0, 4, n)]
    ins = ev & (kind == 1)
    reps = (~(ev & (kind == 2))).astype(np.int64) + ins
    out = np.repeat(np.where(ev & (kind == 0), sub, a), reps)
    out[(np.cumsum(reps) - 1)[ins]] = extra[ins]
    return out.tobytes()


def make_read_fast(rng: np.random.Generator, bc: str, cdna_len: int = 400,
                   error_rate: float = 0.0, reverse: bool = False,
                   polya_len: int = 20) -> dict:
    """`make_read`'s 3' layout (TSO + cDNA + polyA + rc(UMI) + rc(BC) +
    rc(adapter)), vectorized; returns dict(seq, qual, bc)."""
    stranded = (TSO.encode() + random_bytes(rng, cdna_len)
                + b"A" * polya_len + revcomp_bytes(random_bytes(rng, 12))
                + revcomp_bytes(bc.encode()) + revcomp_bytes(ADAPTER.encode()))
    stranded = mutate_fast(rng, stranded, error_rate)
    seq = revcomp_bytes(stranded) if reverse else stranded
    return {"seq": seq, "qual": b"I" * len(seq), "bc": bc}
