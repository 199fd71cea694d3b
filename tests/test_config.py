from pathlib import Path

from sicelore_tpu.utils.config import (DynamicEDTable, PipelineConfig, load_config_xml)

DATA = Path(__file__).parent / "data"
REF_CONFIG = DATA / "config.xml"            # reference-format fixtures
REF_BC_ED = DATA / "bcMaxEditDistances.xml"


def test_defaults():
    cfg = PipelineConfig()
    assert cfg.barcodes.cell_bc_length == 16
    assert cfg.umis.umi_length == 12
    assert cfg.adapter3p.sequence == "CTTCCGATCT"
    assert cfg.sam_tags["CELL_BC"] == "BC"
    assert cfg.sam_tags["UMI_SEQ"] == "U8"


def test_load_reference_config_xml():
    cfg = load_config_xml(REF_CONFIG)
    assert cfg.readscanner.min_read_length == 200
    assert cfg.readscanner.cells_with_reads_nfold_below_max_to_keep == 500
    assert cfg.polyat.polyat_length == 15
    assert cfg.polyat.fraction_at_in_polyat == 0.75
    assert cfg.polyat.window_search_for_polya == 150
    assert cfg.adapter3p.sequence == "CTTCCGATCT"
    assert cfg.adapter3p.sequence_complete == "CTACACGACGCTCTTCCGATCT"
    assert cfg.adapter3p.max_needleman_mismatches == 3
    assert cfg.tso3p.sequence == "AACGCAGAGTACATGG"
    assert cfg.tso3p.max_needleman_mismatches == 5
    assert cfg.tso3p.min_tso_consecutive_matches == 8
    assert cfg.tso3p.window_for_tso_search == 90
    assert cfg.barcodes.cell_bc_length == 16
    assert cfg.umis.umi_length == 12
    assert cfg.umis.umi_completelink_clustering_ed == 2
    assert cfg.umis.umi_singlelink_clustering_ed == 1
    assert cfg.umis.max_complexity_for_umi_clustering == 100_000
    assert cfg.umis.pregroup_for_clustering_threshold == 1_000
    assert cfg.umis.complexity_threshold_for_switch_to_single_link == 3_000
    assert cfg.barcode_umi_finder.sam_records_chunk_size == 250_000
    # samFlags remaps survive the round trip
    assert cfg.sam_tags["CELL_BC"] == "BC"
    assert cfg.sam_tags["UMI_SEQ"] == "U8"
    assert cfg.sam_tags["UMI_ED"] == "U1"
    assert cfg.sam_tags["BARCODE_ED"] == "B1"


def test_dynamic_ed_table():
    t = DynamicEDTable.load(REF_BC_ED)
    # Reference values for BC length 16 at 1% error (SURVEY.md)
    assert t.max_ed(16, 1, 50) == 4
    assert t.max_ed(16, 1, 1000) == 3
    assert t.max_ed(16, 1, 20000) == 2
    assert t.max_ed(16, 1, 90000) == 1
    assert t.max_ed(16, 1, 200000) == 0
