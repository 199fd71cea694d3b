"""Multi-host scan: a 2-process CPU cluster must reproduce the single-host
run exactly.

Each process owns files[pid::2]; pass-1 counts psum-merge so both derive
the identical used-barcode list; process 0 writes merged stats +
BarcodesAssigned. Asserted: used list, BarcodesAssigned.tsv bytes, and the
union of passed/ outputs all equal the single-process run.
"""
import gzip
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sicelore_tpu.pipeline.scanfastq import ScanFastqPipeline
from sicelore_tpu.utils import synth

REPO = Path(__file__).resolve().parents[1]

WORKER = """
import sys, json
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address={coord!r},
                           num_processes=2, process_id={pid})
import numpy as np
from pathlib import Path
from sicelore_tpu.pipeline.scanfastq import ScanFastqPipeline
wl = json.loads(Path({wl_json!r}).read_text())
pipe = ScanFastqPipeline(whitelist=wl, user_max_ed=2, chunk_size=64)
stats = pipe.run([{fq_dir!r}], {out_dir!r})
Path({out_dir!r}, f"proc{{jax.process_index()}}.json").write_text(
    json.dumps({{"used": pipe.used_strs, "assigned": stats.bc_assigned}}))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_run_matches_single(tmp_path):
    rng = np.random.default_rng(5)
    wl = synth.make_whitelist(rng, 64)
    cells = wl[:6]
    fq_dir = tmp_path / "fastq"
    fq_dir.mkdir()
    k = 0
    for f in range(4):
        with gzip.open(fq_dir / f"part{f}.fastq.gz", "wb") as fh:
            for i in range(120):
                cell = cells[int(rng.integers(0, len(cells)))]
                r = synth.make_read(rng, cell,
                                    cdna_len=int(rng.integers(120, 300)),
                                    error_rate=0.04,
                                    reverse=bool(rng.random() < 0.5))
                fh.write(b"@r%d\n" % k + r["seq"] + b"\n+\n"
                         + r["qual"] + b"\n")
                k += 1

    # single-process reference
    ref = ScanFastqPipeline(whitelist=list(wl), user_max_ed=2, chunk_size=64)
    s_ref = ref.run([fq_dir], tmp_path / "one")

    # 2-process cluster
    wl_json = tmp_path / "wl.json"
    wl_json.write_text(json.dumps(list(wl)))
    out_dir = tmp_path / "multi"
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = []
    for pid in range(2):
        script = WORKER.format(repo=str(REPO), coord=coord, pid=pid,
                               wl_json=str(wl_json), fq_dir=str(fq_dir),
                               out_dir=str(out_dir))
        procs.append(subprocess.Popen([sys.executable, "-c", script],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    d0 = json.loads((out_dir / "proc0.json").read_text())
    d1 = json.loads((out_dir / "proc1.json").read_text())
    # identical used lists on both hosts (from the merged pass-1 counts)
    assert d0["used"] == d1["used"] == ref.used_strs
    # per-host assignments sum to the single-host total (stats are merged,
    # so both report the global number)
    assert d0["assigned"] == d1["assigned"] == s_ref.bc_assigned
    # merged BarcodesAssigned equals the single-host file
    ba = "BarcodesAssigned.tsv"
    assert ((out_dir / ba).read_bytes()
            == (tmp_path / "one" / ba).read_bytes())
    # union of passed outputs equals the single-host passed outputs
    def passed(d):
        return {f.name: f.read_bytes() for f in (d / "passed").iterdir()}
    assert passed(out_dir) == passed(tmp_path / "one")
