"""Multi-chip pipeline mode: sharded runs must equal single-chip runs.

ScanFastqPipeline(mesh=...) routes both scan passes
through shard_map dispatchers and BatchedConsensusEngine(mesh=...) routes
votes through the psum-merged consensus step. These tests run a mini
end-to-end (fastq dir -> passed fastq + BarcodesAssigned + clustering ->
consensus) on an 8-device CPU mesh and assert byte equality with the
single-device path.
"""
import gzip

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from sicelore_tpu.ops.poa_tpu import BatchedConsensusEngine
from sicelore_tpu.pipeline.scanfastq import ScanFastqPipeline
from sicelore_tpu.utils import synth
from sicelore_tpu.utils.config import PipelineConfig


def _data_mesh(n=8):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), ("data",))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("mcrun")
    wl = synth.make_whitelist(rng, 128)
    cells = wl[:8]
    recs = []
    for i in range(400):
        cell = cells[int(rng.integers(0, 8))]
        r = synth.make_read(rng, cell, cdna_len=int(rng.integers(150, 500)),
                            error_rate=0.05, reverse=bool(rng.random() < 0.5))
        recs.append((f"r{i}".encode(), r["seq"], r["qual"]))
    for i in range(10):
        s = synth.random_seq(rng, 300).encode()
        recs.append((f"g{i}".encode(), s, b"I" * len(s)))
    with gzip.open(d / "reads.fastq.gz", "wb") as fh:
        for n, s, q in recs:
            fh.write(b"@" + n + b"\n" + s + b"\n+\n" + q + b"\n")
    return d, wl


def _passed_bytes(out):
    return b"".join(f.read_bytes()
                    for f in sorted((out / "passed").iterdir()))


def test_scan_pipeline_mesh_equals_single(run_dir, tmp_path):
    d, wl = run_dir
    ref = ScanFastqPipeline(PipelineConfig(), whitelist=wl, user_max_ed=2,
                            chunk_size=128)
    s_ref = ref.run([d], tmp_path / "one")

    mesh = _data_mesh(8)
    mc = ScanFastqPipeline(PipelineConfig(), whitelist=wl, user_max_ed=2,
                           chunk_size=128, mesh=mesh)
    s_mc = mc.run([d], tmp_path / "multi")

    assert s_mc.total_reads == s_ref.total_reads
    assert s_mc.bc_assigned == s_ref.bc_assigned
    assert mc.used_strs == ref.used_strs
    assert _passed_bytes(tmp_path / "multi") == _passed_bytes(tmp_path / "one")
    ba = "BarcodesAssigned.tsv"
    assert ((tmp_path / "multi" / ba).read_bytes()
            == (tmp_path / "one" / ba).read_bytes())


def test_consensus_mesh_equals_single(run_dir):
    rng = np.random.default_rng(3)
    molecules = []
    for i in range(37):  # mixed sizes incl. 1-read and 2-read shortcuts
        truth = synth.random_seq(rng, int(rng.integers(60, 220)))
        n = int(rng.integers(1, 7))
        molecules.append([synth.mutate(rng, truth, 0.04).encode()
                          for _ in range(n)])
    ref = BatchedConsensusEngine()(molecules)
    mc = BatchedConsensusEngine(mesh=_data_mesh(8))(molecules)
    assert mc == ref
