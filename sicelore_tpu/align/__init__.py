"""Native spliced long-read aligner (the minimap2 role, SURVEY §2.c).

The reference pipeline shells out to `minimap2 -ax splice -uf` for every
mapping step (sicelore-nf main.nf, SURVEY.md) — the last
foreign compute dependency. This package replaces it for locus/
chromosome-scale references (the quickrun's chr12 use case) with the
framework's own machinery:

  * index:  vectorized minimizer index (numpy build, sorted-array probes)
  * chain:  minimap2-style anchor chaining with intron-tolerant gap costs
  * extend: between-anchor gap alignment BATCHED ON DEVICE through the
            same banded-NW alignment the consensus engine runs
            (ops/poa_tpu.band_align — walk records decode into CIGAR runs
            instead of votes), GT-AG junction snapping
  * aligner: fastq -> sorted+indexed BAM with the tags downstream stages
            consume (de divergence, NM/AS/tp)
"""
from sicelore_tpu.align.aligner import NativeAligner  # noqa: F401
