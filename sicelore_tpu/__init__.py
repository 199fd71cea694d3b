"""sicelore_tpu — single-cell Nanopore long-read analysis engine in JAX.

A from-scratch JAX/XLA framework with the capabilities of SiCeLoRe 2.1
(https://github.com/ucagenomix/sicelore-2.1): read stranding, polyA/adapter/TSO
scanning, chimera splitting, cell-barcode assignment against the 10x whitelist,
edit-distance UMI clustering, per-UMI partial-order-alignment consensus,
cellBC x gene/isoform/junction count matrices, per-cell SNV calling, fusion
detection and novel-isoform discovery.

Design: reads live as fixed-shape padded int8 tensor batches ("structure of
arrays"); all inner loops (Myers bit-parallel edit distance, Needleman-Wunsch
adapter scan, polyA window scan, POA consensus) are jnp/lax programs, with
Pallas/Triton kernels for the barcode sweep and the band alignment;
metadata codecs (read names, SAM tags) reproduce the reference's on-disk
contracts at the I/O boundary only.

Subpackages:
  ops       device ops (plain jnp versions + Triton kernels)
  core      pipeline data model (ReadBatch, molecules, matrices, clustering)
  io        fastq/BAM/refFlat/BED/GTF codecs
  models    gene/transcript models + barcode whitelist model
  parallel  mesh construction + sharded dispatch
  pipeline  CLI programs mirroring the reference's command surface
  utils     config system, DNA encoding, logging
"""

__version__ = "0.1.0"
