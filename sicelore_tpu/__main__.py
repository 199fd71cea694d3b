"""sicelore_tpu CLI — mirrors the reference command surface.

Engine A commands (reference NanoporeBC_UMI_finder-2.1.jar,
com.rw.parsermain.Main): scanfastq, assignumis, tagbamwithread.
Engine B commands (reference Sicelore-2.1.jar, org.ipmc.sicelore.cmdline):
added as programs land (isoformmatrix, computeconsensus, ...).

Usage: python -m sicelore_tpu <command> [options]
Reference CLI spec: the reference README's command sections (SURVEY.md).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _add_scanfastq(sub):
    p = sub.add_parser("scanfastq", help="strand reads, split chimeras, "
                       "assign cell barcodes (reference scanfastq)")
    p.add_argument("-d", "--inDir", required=True,
                   help="comma-separated directories/files to search for fastq")
    p.add_argument("-o", "--outDir", required=True)
    p.add_argument("-b", "--bcEditDistance", type=int, default=1,
                   help="max edit distance for barcode assignment (default 1)")
    p.add_argument("-g", "--cellRangerBCs", default=None,
                   help="tsv of known cell barcodes; skips pass-1 discovery")
    p.add_argument("--whitelist", default=None,
                   help="10x whitelist file (3M-february-2018.txt.gz / 737K)")
    p.add_argument("-e", "--randomBarcode", action="store_true",
                   help="negative control: replace BC windows with random seq")
    p.add_argument("-5", "--fivePbc", action="store_true",
                   help="5' barcoding chemistry (reference -h/--fivePbc)")
    p.add_argument("--demon", action="store_true",
                   help="keep watching the input dirs for new fastq files "
                        "(reference runningasdemon)")
    p.add_argument("--pollInterval", type=float, default=30.0)
    p.add_argument("--idleTimeout", type=float, default=600.0)
    p.add_argument("-c", "--compress", action="store_true")
    p.add_argument("-v", "--pattern", default=r".{1,}\.(fastq|fq)(\.gz)?$")
    p.add_argument("--config", default=None, help="reference-format config.xml")
    p.add_argument("--chunkSize", type=int, default=50_000)
    p.add_argument("--errorPercent", type=int, default=1,
                   help="assumed read error %% for the dynamic ED table")
    return p


def _add_assignumis(sub):
    p = sub.add_parser("assignumis", help="per-cell per-region UMI "
                       "clustering on a sorted BAM (reference assignumis)")
    p.add_argument("-i", "--inFileNanopore", required=True,
                   help="sorted Nanopore BAM (scanfastq read names)")
    p.add_argument("-o", "--outfile", required=True)
    p.add_argument("-a", "--annotationFile", default=None,
                   help="refFlat for GE gene tagging + genecounts")
    p.add_argument("-f", "--randomUMI", action="store_true",
                   help="negative control: random UMI sequences")
    p.add_argument("--illumina", default=None,
                   help="parseillumina table (json.gz) for guided mode")
    p.add_argument("--config", default=None)
    return p


def cmd_assignumis(args) -> int:
    from pathlib import Path as _P

    from sicelore_tpu.pipeline.assignumis import AssignUmisPipeline
    from sicelore_tpu.utils.config import PipelineConfig, load_config_xml

    cfg = load_config_xml(args.config) if args.config else PipelineConfig()
    illum = None
    if args.illumina:
        from sicelore_tpu.pipeline.illumina import GuidedUmiTable
        illum = GuidedUmiTable(args.illumina)
    pipe = AssignUmisPipeline(cfg, refflat=args.annotationFile,
                              random_umi=args.randomUMI,
                              illumina_table=illum)
    out = _P(args.outfile)
    stats = pipe.run(args.inFileNanopore, out,
                     genecounts_tsv=out.with_suffix("").with_name(
                         out.stem + ".genecounts.tsv"),
                     umidepths_tsv=out.with_suffix("").with_name(
                         out.stem + ".UMIdepths.tsv"),
                     log_json=str(out) + ".log")
    print(f"assignumis done: {stats.total_records} records, "
          f"{stats.umi_assigned} UMI-assigned "
          f"({stats.clustered} clusters, {stats.singletons} singletons)")
    return 0


def _add_computeconsensus(sub):
    p = sub.add_parser("computeconsensus", help="per-molecule consensus "
                       "fastq (reference ComputeConsensus; native engine, "
                       "no spoa)")
    p.add_argument("-I", "--INPUT", required=True,
                   help="BC/U8-tagged BAM with US/CS sequence tags")
    p.add_argument("-O", "--OUTPUT", required=True, help="output fastq")
    p.add_argument("--MAXREADS", type=int, default=20)
    p.add_argument("--MINPS", type=int, default=3)
    p.add_argument("--MAXPS", type=int, default=20)
    p.add_argument("--host-engine", action="store_true",
                   help="force the host consensus engine (no device)")
    p.add_argument("--refine", action="store_true",
                   help="second alignment pass re-centered on the pass-1 "
                        "consensus (~2x device time; accuracy deltas in "
                        "docs/CONSENSUS_ACCURACY.md)")
    return p


def cmd_computeconsensus(args) -> int:
    from sicelore_tpu.pipeline.consensus import compute_consensus

    engine = None
    if not args.host_engine:
        from sicelore_tpu.ops.poa_tpu import BatchedConsensusEngine
        engine = BatchedConsensusEngine(maxreads=args.MAXREADS)
        if args.refine:
            import functools
            engine = functools.partial(engine, refine=True)
    stats = compute_consensus(args.INPUT, args.OUTPUT,
                              maxreads=args.MAXREADS, minps=args.MINPS,
                              maxps=args.MAXPS, engine=engine,
                              log_json=str(args.OUTPUT) + ".log")
    print(f"computeconsensus done: {stats['written']}/{stats['molecules']} "
          f"molecules")
    return 0


def _add_isoformmatrix(sub):
    p = sub.add_parser("isoformmatrix", help="cell x isoform/gene/junction "
                       "UMI matrices (reference IsoformMatrix)")
    p.add_argument("-I", "--INPUT", required=True, help="BC/U8/GE-tagged BAM")
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-C", "--CSV", required=True, help="cell barcode csv")
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-P", "--PREFIX", default="sicelore")
    p.add_argument("--DELTA", type=int, default=2)
    p.add_argument("--METHOD", default="STRICT")
    p.add_argument("--AMBIGUOUS_ASSIGN", action="store_true")
    p.add_argument("--MAPQV0", action="store_true")
    p.add_argument("--ISOBAM", action="store_true")
    p.add_argument("--TOBULK", action="store_true")
    return p


def cmd_isoformmatrix(args) -> int:
    from sicelore_tpu.pipeline.isoform import isoform_matrix

    log = isoform_matrix(args.INPUT, args.REFFLAT, args.CSV, args.OUTDIR,
                         prefix=args.PREFIX, delta=args.DELTA,
                         method=args.METHOD,
                         ambiguous_assign=args.AMBIGUOUS_ASSIGN,
                         mapqv0=args.MAPQV0, isobam=args.ISOBAM,
                         tobulk=args.TOBULK)
    print(f"isoformmatrix done: {log['molecules']} molecules, "
          f"{log['matrix_isoforms']} isoform rows, "
          f"{log['isoform_def']} defined / {log['isoform_undef']} undef")
    return 0


def cmd_scanfastq(args) -> int:
    import numpy as np

    from sicelore_tpu.pipeline.scanfastq import ScanFastqPipeline, load_whitelist
    from sicelore_tpu.utils.config import PipelineConfig, load_config_xml

    cfg = load_config_xml(args.config) if args.config else PipelineConfig()
    if args.fivePbc:
        cfg.chemistry = "5p"
    if args.cellRangerBCs:
        bcs = [l.strip().split("-")[0] for l in open(args.cellRangerBCs)
               if l.strip()]
        wl = bcs
    elif args.whitelist:
        wl = load_whitelist(args.whitelist)
    else:
        print("ERROR: provide --whitelist (10x barcode list) or "
              "-g/--cellRangerBCs", file=sys.stderr)
        return 2
    pipe = ScanFastqPipeline(cfg, whitelist=wl,
                             random_barcode=args.randomBarcode,
                             chunk_size=args.chunkSize,
                             error_percent=args.errorPercent,
                             user_max_ed=args.bcEditDistance,
                             known_cells=bool(args.cellRangerBCs),
                             compress=args.compress)
    inputs = [Path(s) for s in args.inDir.split(",")]
    if args.demon:
        stats = pipe.run_demon(inputs, args.outDir,
                               poll_interval=args.pollInterval,
                               idle_timeout=args.idleTimeout)
    else:
        stats = pipe.run(inputs, args.outDir)
    print(f"scanfastq done: {stats.total_reads} reads, "
          f"{stats.stranded} stranded, {stats.bc_assigned} BC-assigned "
          f"({stats.split_chimeric} chimera splits, "
          f"{stats.multi_chimeric_discarded} multi-chimeric discarded)")
    return 0


def _add_simple_programs(sub):
    """Host-side stream-rewrite programs (pipeline.programs, .snp_fusion)."""
    p = sub.add_parser("tagbamwithread", help="add US/QS read-sequence tags "
                       "from fastq (reference tagbamwithread)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("-F", "--FASTQ", required=True, help="fastq file or dir")

    p = sub.add_parser("deduplicatemolecule",
                       help="dedup consensus fastq by (BC,U8), keep max RN")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("addbammoleculetags",
                       help="read name BC-U8-RN -> BC/U8/RN tags")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("addgenenametag", help="GE gene tag from refFlat "
                       "overlap (reference AddGeneNameTag)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("-R", "--REFFLAT", required=True)

    p = sub.add_parser("bam2fastq", help="BAM -> fastq (optionally from "
                       "US/QS tags)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--SEQTAG", default=None)
    p.add_argument("--QUALTAG", default=None)

    p = sub.add_parser("filterbam", help="drop mapqv0 / tag-missing records")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--TAG", default=None, help="required tag")

    p = sub.add_parser("snpmatrix", help="per-cell SNV matrix (reference "
                       "SNPMatrix)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-S", "--SNP", required=True,
                   help="csv: chrom,pos[|pos2..],strand,name")
    p.add_argument("-C", "--CSV", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-P", "--PREFIX", default="snp")
    p.add_argument("--MINRN", type=int, default=0)
    p.add_argument("--MINQV", type=int, default=0)

    p = sub.add_parser("fusiondetector", help="2-gene molecules -> fusion "
                       "matrix (reference FusionDetector)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-C", "--CSV", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-P", "--PREFIX", default="fus")

    p = sub.add_parser("exportclippedreads", help="export clipped reads as "
                       "fastq (reference ExportClippedReads)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--MINCLIP", type=int, default=150)

    p = sub.add_parser("addbamreadtags",
                       help="read name read_GE_BC_U8 -> tags")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("sortbam", help="coordinate-sort a BAM")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("selectvalidcellbarcode",
                       help="filter BarcodesAssigned.tsv -> barcodes.csv")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--MINUMI", type=int, default=1)
    p.add_argument("--ED0ED1RATIO", type=float, default=1.0)

    for nm, hlp in (("filterbammf", "cell-list filter + CB/UB 10x retag"),
                    ("cleanusuq", "blank US/UQ tags (kept, empty value)"),
                    ("exportumifoundrecords", "keep BC+U8 records"),
                    ("filtermoleculebam", "filter molecules on RN/isoform")):
        p = sub.add_parser(nm, help=hlp)
        p.add_argument("-I", "--INPUT", required=True)
        p.add_argument("-O", "--OUTPUT", required=True)
        if nm == "filtermoleculebam":
            p.add_argument("--MINRN", type=int, default=1)
            p.add_argument("--ISOONLY", action="store_true")
        if nm == "filterbammf":
            p.add_argument("-C", "--CSV", required=True,
                           help="valid cell barcodes csv")

    p = sub.add_parser("addlabel2barcode", help="BC -> BC-LABEL")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("-L", "--LABEL", required=True)

    p = sub.add_parser("splitbam",
                       help="yes.bam/no.bam by read-name-prefix id list")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True, help="output DIRECTORY")
    p.add_argument("--IDS", required=True)

    p = sub.add_parser("splitbampercell", help="one BAM per cell")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-C", "--CSV", required=True)

    p = sub.add_parser("splitbampercluster", help="one BAM per cluster "
                       "(csv: barcode,cluster)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-C", "--CSV", required=True)

    p = sub.add_parser("splitbamperstage", help="one BAM per stage "
                       "(csv: sample,stage; routed by BC '-sample' suffix)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-C", "--CSV", required=True)
    p.add_argument("--CELLTAG", default="BC")

    p = sub.add_parser("crisprstats", help="largest-deletion histogram "
                       "over a genomic window (CRISPR editing QC)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("--HISTO", required=True)
    p.add_argument("--DETAIL", required=True)
    p.add_argument("--MINSIZE", type=int, default=10)
    p.add_argument("--COORD", default="21:17608000-17610000")

    p = sub.add_parser("parsefastq", help="export cDNA slice of passed "
                       "fastq reads using read-name metadata")
    p.add_argument("-I", "--FASTQDIR", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("--offset", type=int, default=28)
    p.add_argument("--min_cdna", type=int, default=20)

    p = sub.add_parser("parsetr", help="Parse Biosciences polyT vs random"
                       "-hexamer priming stats per gene/cell")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-C", "--CSV", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("--CELLTAG_BC", default="CR")
    p.add_argument("--CELLTAG", default="CB")
    p.add_argument("--UMITAG", default="pN")
    p.add_argument("--GENETAG", default="GN")
    p.add_argument("--XF", default="XF")
    p.add_argument("--SAMPLE", default="pS")

    p = sub.add_parser("precompile", help="warm the persistent XLA "
                       "compile cache for all pipeline device shapes")
    p.add_argument("--nbc", type=int, default=8192,
                   help="used-barcode list size to warm the sweep for")
    p.add_argument("--full", action="store_true",
                   help="also warm tail buckets + internal-scan shapes")

    p = sub.add_parser("moleculecounter", help="count distinct (BC,U8)")
    p.add_argument("-I", "--INPUT", required=True)

    p = sub.add_parser("exportmetrics", help="per-molecule + per-cell "
                       "metrics from a tagged BAM (ExportMetrics)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-C", "--CSV", required=True, help="cell barcodes csv")
    p.add_argument("--OM", required=True, help="molecule metrics output")
    p.add_argument("--OC", required=True, help="cell metrics output")
    p.add_argument("--CELLTAG", default="CB")
    p.add_argument("--UMITAG", default="UB")
    p.add_argument("--GENETAG", default="GN")

    p = sub.add_parser("exportmoleculereads",
                       help="fastq of listed molecules' reads")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-C", "--CSV", required=True, help="csv: barcode,umi")
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("addreadstomolecules",
                       help="merge targeted reads into standard molecules")
    p.add_argument("-I", "--INPUT", required=True, help="standard BAM")
    p.add_argument("-T", "--TARGETED", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("haplotypecaller",
                       help="per-isoform evidence fasta export")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)

    p = sub.add_parser("mergescanstats", help="merge scanner stats / "
                       "BarcodesAssigned tables across runs (statmerger)")
    p.add_argument("-I", "--INPUTS", required=True,
                   help="comma-separated stats.json or tsv files")
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("parseillumina", help="serialize an Illumina 10x BAM "
                       "into a guided-mode table (reference parseillumina/"
                       "BamSerializer)")
    p.add_argument("-I", "--INPUT", required=True, help="Illumina BAM "
                   "(CB/UB/GN tags)")
    p.add_argument("-O", "--OUTPUT", required=True, help="table json.gz")

    p = sub.add_parser("annotatemodel",
                       help="re-validate a CollapseModel txt")
    p.add_argument("-M", "--MODEL", required=True, help="CollapseModel txt")
    p.add_argument("-I", "--INPUT", default=None, help="short-read BAM")
    p.add_argument("--CAGE", default=None)
    p.add_argument("--POLYA", default=None)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("junctionvalidator",
                       help="classify a junction table vs refFlat")
    p.add_argument("-I", "--INPUT", required=True, help="junction tsv")
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--SHORT", default=None)

    p = sub.add_parser("snpmatrix3pend",
                       help="SNV distance to isoform 3' end")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-S", "--SNP", required=True)
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("addisobam",
                       help="per-record STRICT isoform re-assignment -> IT")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--DELTA", type=int, default=2)
    p.add_argument("--MAXCLIP", type=int, default=150)

    p = sub.add_parser("isobam",
                       help="molinfos-driven record filter + IG/IT tags")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("--MOLINFOS", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--NOUNDEF", action="store_true",
                   help="drop molecules with transcriptId=undef")

    p = sub.add_parser("junctionannotate",
                       help="GT-AG donor/acceptor annotation from genome")
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-G", "--GENOME", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("samview", help="SAM <-> BAM conversion "
                       "(samtools-view role)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("run", help="full pipeline orchestrator "
                       "(reference sicelore-nf/quickrun)")
    p.add_argument("-d", "--fastqDir", required=True)
    p.add_argument("-r", "--reference", required=True, help="genome fasta")
    p.add_argument("-a", "--refflat", required=True)
    p.add_argument("-o", "--outDir", required=True)
    p.add_argument("--whitelist", default=None)
    p.add_argument("-g", "--cellRangerBCs", default=None)
    p.add_argument("-b", "--bcEditDistance", type=int, default=1)
    p.add_argument("--juncBed", default=None)
    p.add_argument("--minimap2", default=None)
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("--consensus", action="store_true")
    p.add_argument("--collapse", action="store_true")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--nativeAlign", action="store_true",
                   help="use the framework's own spliced aligner instead "
                        "of the minimap2 subprocess (align/ package)")

    p = sub.add_parser("align", help="spliced long-read alignment -> "
                       "sorted BAM+BAI (the minimap2 -ax splice role, "
                       "framework-native)")
    p.add_argument("-r", "--reference", required=True, help="genome fasta")
    p.add_argument("-d", "--fastq", required=True,
                   help="fastq file or directory")
    p.add_argument("-O", "--OUTPUT", required=True, help="output BAM")
    p.add_argument("--juncBed", default=None,
                   help="annotated junction BED (chrom/start/end), the "
                        "minimap2 --junc-bed role")
    p.add_argument("--keep-unmapped", action="store_true")

    p = sub.add_parser("histo", help="histogram programs (reference Histo*)")
    p.add_argument("KIND", choices=["readlength", "fastqmeanqv", "clipping",
                                    "moleculelength", "percentidentity",
                                    "umidepth"])
    p.add_argument("-I", "--INPUT", required=True, help="BAM or fastq")
    p.add_argument("-O", "--OUTPUT", required=True, help="output prefix")

    p = sub.add_parser("saturationcurve", help="sequencing saturation "
                       "(reference SaturationCurve)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True, help="output prefix")

    p = sub.add_parser("readbamstats", help="BAM counter dump")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", default=None, help="json output")

    p = sub.add_parser("exporteditdistances",
                       help="per-record BC/UMI ED tsv (reference EditDistance)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("bulk2fakesinglecell", help="constant-BC synthetic "
                       "reads (reference Bulk2FakeSingleCell)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--BARCODE", default="AAAACCCCGGGGTTTT")

    p = sub.add_parser("collapsemodel", help="novel-isoform discovery/"
                       "classification/validation (reference CollapseModel)")
    p.add_argument("-I", "--INPUT", required=True, help="isobam (IG/IT tags)")
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-C", "--CSV", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-P", "--PREFIX", default="CollapseModel")
    p.add_argument("--DELTA", type=int, default=2)
    p.add_argument("--MINEVIDENCE", type=int, default=2)
    p.add_argument("--RNMIN", type=int, default=1)
    p.add_argument("--CAGE", default=None, help="CAGE peaks BED")
    p.add_argument("--POLYA", default=None, help="polyA sites BED")
    p.add_argument("--SHORT", default=None, help="short-read BAM")
    p.add_argument("--cageCo", type=int, default=50)
    p.add_argument("--polyaCo", type=int, default=50)
    p.add_argument("--juncCo", type=int, default=1)


def cmd_simple(args) -> int:
    from sicelore_tpu.pipeline import programs, snp_fusion

    if args.cmd == "tagbamwithread":
        r = programs.tag_bam_with_read(args.INPUT, args.OUTPUT, args.FASTQ)
    elif args.cmd == "deduplicatemolecule":
        r = programs.deduplicate_molecule(args.INPUT, args.OUTPUT)
    elif args.cmd == "addbammoleculetags":
        r = programs.add_bam_molecule_tags(args.INPUT, args.OUTPUT)
    elif args.cmd == "addgenenametag":
        r = programs.add_gene_name_tag(args.INPUT, args.OUTPUT, args.REFFLAT)
    elif args.cmd == "bam2fastq":
        r = programs.bam2fastq(args.INPUT, args.OUTPUT, args.SEQTAG,
                               args.QUALTAG)
    elif args.cmd == "filterbam":
        r = programs.filter_bam(args.INPUT, args.OUTPUT,
                                tag_required=args.TAG)
    elif args.cmd == "snpmatrix":
        r = snp_fusion.snp_matrix(args.INPUT, args.SNP, args.CSV,
                                  args.OUTDIR, args.PREFIX, args.MINRN,
                                  args.MINQV)
    elif args.cmd == "fusiondetector":
        r = snp_fusion.fusion_detector(args.INPUT, args.CSV, args.OUTDIR,
                                       args.PREFIX)
    elif args.cmd == "exportclippedreads":
        r = programs.export_clipped_reads(args.INPUT, args.OUTPUT,
                                          min_clip=args.MINCLIP)
    elif args.cmd == "addbamreadtags":
        r = programs.add_bam_read_tags(args.INPUT, args.OUTPUT)
    elif args.cmd == "sortbam":
        from sicelore_tpu.io.bam import sort_bam
        sort_bam(args.INPUT, args.OUTPUT)
        r = {"sorted": True}
    elif args.cmd == "selectvalidcellbarcode":
        from sicelore_tpu.pipeline import programs2
        r = programs2.select_valid_cell_barcode(args.INPUT, args.OUTPUT,
                                                args.MINUMI,
                                                args.ED0ED1RATIO)
    elif args.cmd == "filterbammf":
        from sicelore_tpu.pipeline import programs2
        r = programs2.filter_bam_mf(args.INPUT, args.OUTPUT, args.CSV)
    elif args.cmd == "filtermoleculebam":
        from sicelore_tpu.pipeline import programs2
        r = programs2.filter_molecule_bam(args.INPUT, args.OUTPUT,
                                          min_rn=args.MINRN,
                                          require_isoform=args.ISOONLY)
    elif args.cmd == "cleanusuq":
        from sicelore_tpu.pipeline import programs2
        r = programs2.clean_usuq(args.INPUT, args.OUTPUT)
    elif args.cmd == "exportumifoundrecords":
        from sicelore_tpu.pipeline import programs2
        r = programs2.export_umifound_records(args.INPUT, args.OUTPUT)
    elif args.cmd == "addlabel2barcode":
        from sicelore_tpu.pipeline import programs2
        r = programs2.add_label_to_barcode(args.INPUT, args.OUTPUT,
                                           args.LABEL)
    elif args.cmd == "splitbam":
        from sicelore_tpu.pipeline import programs2
        r = programs2.split_bam(args.INPUT, args.OUTPUT, args.IDS)
    elif args.cmd == "splitbampercell":
        from sicelore_tpu.pipeline import programs
        r = programs.split_bam_per_cell(args.INPUT, args.OUTDIR, args.CSV)
    elif args.cmd == "splitbampercluster":
        from sicelore_tpu.pipeline import programs2
        r = programs2.split_bam_per_cluster(args.INPUT, args.OUTDIR,
                                            args.CSV)
    elif args.cmd == "splitbamperstage":
        from sicelore_tpu.pipeline import programs2
        r = programs2.split_bam_per_stage(args.INPUT, args.OUTDIR,
                                          args.CSV, args.CELLTAG)
    elif args.cmd == "crisprstats":
        from sicelore_tpu.pipeline import programs2
        r = programs2.crispr_stats(args.INPUT, args.HISTO, args.DETAIL,
                                   args.MINSIZE, args.COORD)
    elif args.cmd == "parsefastq":
        from sicelore_tpu.pipeline import programs2
        r = programs2.parse_fastq_cdna(args.FASTQDIR, args.OUTDIR,
                                       args.offset, args.min_cdna)
    elif args.cmd == "parsetr":
        from sicelore_tpu.pipeline import programs2
        r = programs2.parse_tr_stats(args.INPUT, args.CSV, args.OUTDIR,
                                     args.CELLTAG_BC, args.CELLTAG,
                                     args.UMITAG, args.GENETAG, args.XF,
                                     args.SAMPLE)
    elif args.cmd == "precompile":
        from sicelore_tpu.utils import precompile
        r = precompile.warm(n_bc=args.nbc, full=args.full)
    elif args.cmd == "moleculecounter":
        from sicelore_tpu.pipeline import programs2
        r = programs2.molecule_counter(args.INPUT)
    elif args.cmd == "exportmetrics":
        from sicelore_tpu.pipeline import programs2
        r = programs2.export_metrics(args.INPUT, args.CSV, args.OM, args.OC,
                                     args.CELLTAG, args.UMITAG, args.GENETAG)
    elif args.cmd == "exportmoleculereads":
        from sicelore_tpu.pipeline import programs2
        r = programs2.export_molecule_reads(args.INPUT, args.CSV,
                                            args.OUTPUT)
    elif args.cmd == "addreadstomolecules":
        from sicelore_tpu.pipeline import programs2
        r = programs2.add_reads_to_molecules(args.INPUT, args.TARGETED,
                                             args.OUTPUT)
    elif args.cmd == "haplotypecaller":
        from sicelore_tpu.pipeline import programs2
        r = programs2.haplotype_caller(args.INPUT, args.OUTDIR)
    elif args.cmd == "mergescanstats":
        from sicelore_tpu.pipeline import mergestats
        files = args.INPUTS.split(",")
        if files[0].endswith(".json"):
            r = mergestats.merge_scanner_stats(files, args.OUTPUT)
            r = {"merged": len(files)}
        else:
            r = mergestats.merge_barcodes_assigned(files, args.OUTPUT)
    elif args.cmd == "parseillumina":
        from sicelore_tpu.pipeline.illumina import parse_illumina_bam
        r = parse_illumina_bam(args.INPUT, args.OUTPUT)
    elif args.cmd == "annotatemodel":
        from sicelore_tpu.pipeline import annotate
        r = annotate.annotate_model(args.MODEL, args.INPUT, args.CAGE,
                                    args.POLYA, args.OUTPUT)
    elif args.cmd == "junctionvalidator":
        from sicelore_tpu.pipeline import annotate
        r = annotate.junction_validator(args.INPUT, args.REFFLAT,
                                        args.OUTPUT, short_bam=args.SHORT)
    elif args.cmd == "snpmatrix3pend":
        from sicelore_tpu.pipeline import annotate
        r = annotate.snp_matrix_3pend(args.INPUT, args.SNP, args.REFFLAT,
                                      args.OUTPUT)
    elif args.cmd == "addisobam":
        from sicelore_tpu.pipeline import annotate
        r = annotate.add_isobam(args.INPUT, args.REFFLAT, args.OUTPUT,
                                delta=args.DELTA, max_clip=args.MAXCLIP)
    elif args.cmd == "isobam":
        from sicelore_tpu.pipeline import annotate
        r = annotate.isobam(args.INPUT, args.MOLINFOS, args.OUTPUT,
                            undef=not args.NOUNDEF)
    elif args.cmd == "junctionannotate":
        from sicelore_tpu.pipeline import programs2
        r = programs2.junction_annotate(args.REFFLAT, args.GENOME,
                                        args.OUTPUT)
    elif args.cmd == "samview":
        from sicelore_tpu.io import sam as _sam
        if str(args.INPUT).endswith(".bam"):
            n = _sam.bam_to_sam(args.INPUT, args.OUTPUT)
        else:
            n = _sam.sam_to_bam(args.INPUT, args.OUTPUT)
        r = {"records": n}
    elif args.cmd == "run":
        from sicelore_tpu.pipeline.workflow import run_pipeline
        r = run_pipeline(
            args.fastqDir, args.reference, args.refflat, args.outDir,
            whitelist=args.whitelist, cells_csv=args.cellRangerBCs,
            bc_ed=args.bcEditDistance, junc_bed=args.juncBed,
            minimap2_path=args.minimap2, threads=args.threads,
            with_consensus=args.consensus, with_collapse=args.collapse,
            resume=not args.no_resume, native_align=args.nativeAlign)
        r = {k: "ok" for k in r}
    elif args.cmd == "align":
        from sicelore_tpu.align import NativeAligner
        aln = NativeAligner(args.reference, junc_bed=args.juncBed)
        r = aln.align_fastq_to_bam(args.fastq, args.OUTPUT,
                                   keep_unmapped=args.keep_unmapped)
        print(f"align done: {r['mapped']}/{r['reads']} reads mapped")
    elif args.cmd == "histo":
        from sicelore_tpu.pipeline import qc
        r = qc.histo(args.KIND, args.INPUT, args.OUTPUT)
    elif args.cmd == "saturationcurve":
        from sicelore_tpu.pipeline import qc
        r = qc.saturation_curve(args.INPUT, args.OUTPUT)
    elif args.cmd == "readbamstats":
        from sicelore_tpu.pipeline import qc
        r = qc.read_bam_stats(args.INPUT, args.OUTPUT)
    elif args.cmd == "exporteditdistances":
        from sicelore_tpu.pipeline import qc
        r = qc.export_edit_distances(args.INPUT, args.OUTPUT)
    elif args.cmd == "bulk2fakesinglecell":
        from sicelore_tpu.pipeline import qc
        r = qc.bulk2fake_single_cell(args.INPUT, args.OUTPUT,
                                     barcode=args.BARCODE)
    elif args.cmd == "collapsemodel":
        from sicelore_tpu.pipeline.collapsemodel import collapse_model
        r = collapse_model(args.INPUT, args.REFFLAT, args.CSV, args.OUTDIR,
                           prefix=args.PREFIX, delta=args.DELTA,
                           min_evidence=args.MINEVIDENCE, rn_min=args.RNMIN,
                           cage_bed=args.CAGE, polya_bed=args.POLYA,
                           short_bam=args.SHORT, cage_cutoff=args.cageCo,
                           polya_cutoff=args.polyaCo,
                           junc_cutoff=args.juncCo)
        r = {k: v for k, v in r.items()
             if not str(k).endswith(("_evidences", "_evidences_valid"))
             and v}
    else:
        return 2
    print(f"{args.cmd} done: {r}")
    return 0


_SIMPLE = {"tagbamwithread", "deduplicatemolecule", "addbammoleculetags",
           "addgenenametag", "bam2fastq", "filterbam", "snpmatrix",
           "fusiondetector", "exportclippedreads", "addbamreadtags",
           "sortbam", "collapsemodel", "histo", "saturationcurve",
           "readbamstats", "exporteditdistances", "bulk2fakesinglecell",
           "samview", "run", "selectvalidcellbarcode", "filterbammf",
           "filtermoleculebam", "cleanusuq", "exportumifoundrecords",
           "addlabel2barcode", "splitbam", "splitbampercell",
           "splitbampercluster", "moleculecounter", "exportmoleculereads",
           "addreadstomolecules", "haplotypecaller", "junctionannotate",
           "annotatemodel", "junctionvalidator", "snpmatrix3pend",
           "addisobam", "isobam", "parseillumina", "mergescanstats",
           "splitbamperstage", "crisprstats", "parsefastq", "parsetr",
           "precompile"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sicelore_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_scanfastq(sub)
    _add_assignumis(sub)
    _add_isoformmatrix(sub)
    _add_computeconsensus(sub)
    _add_simple_programs(sub)
    args = ap.parse_args(argv)
    from sicelore_tpu.utils.jaxcache import enable_compile_cache
    enable_compile_cache()
    if args.cmd == "scanfastq":
        return cmd_scanfastq(args)
    if args.cmd == "assignumis":
        return cmd_assignumis(args)
    if args.cmd == "isoformmatrix":
        return cmd_isoformmatrix(args)
    if args.cmd == "computeconsensus":
        return cmd_computeconsensus(args)
    if args.cmd in _SIMPLE:
        return cmd_simple(args)
    ap.error(f"unknown command {args.cmd}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
