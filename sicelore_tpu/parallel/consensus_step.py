"""Multi-device sharded consensus step.

Consensus pairs (center, read) are embarrassingly data-parallel: each
device aligns its shard of pairs (ops.poa_tpu.band_align — the same
function the single-device engine and the aligner call), per-molecule
vote tensors merge with a psum (molecules are assigned whole to a shard,
so the psum simply gathers each molecule's votes from the single device
that produced them — zero elsewhere), and the assembly (argmax + QV +
sort-compaction, ops.poa_tpu.assemble_votes) runs replicated on the merged
votes. This is the analog of the reference's consensus thread pool
(MoleculeDataset.callConsensus, utils/MoleculeDataset.java:659-743).
"""
from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sicelore_tpu.ops import poa_tpu


def make_sharded_bucket_fn(mesh: Mesh, Lc: int, Pp: int, n2: int,
                           maxps: int, out_cols: int,
                           data_axis: str = "data"):
    """Jitted fn(reads2b [E, Pp] u8, rl [Pp], mids [Pp], cmol2b
    [n2, Lc//4] u8, clm [n2]) -> merged [n2, out_cols + 5] u8 (same
    contract as the single-device fused bucket fn in
    BatchedConsensusEngine._bucket_fn).

    Pairs shard over `data_axis` (Pp divisible by axis_size *
    PAIR_STEP); centers/molecule rows replicate; per-shard votes
    psum-merge; assembly runs replicated — results are byte-identical to
    one device because vote addition is exact and every molecule's pairs
    contribute once wherever they live."""
    n_data = int(mesh.shape[data_axis])
    assert Pp % (n_data * poa_tpu.PAIR_STEP) == 0, (Pp, n_data)

    def local(reads2b, rl, mids, cmol2b, clm):
        aligned, ins, feas, cmol = poa_tpu.band_align(
            reads2b, rl, mids, cmol2b, clm, Lc)
        cv, iv, pc = poa_tpu.segment_votes(aligned, ins, feas, mids, n2)
        cv = jax.lax.psum(cv, data_axis)
        iv = jax.lax.psum(iv, data_axis)
        pc = jax.lax.psum(pc, data_axis)
        packed, out_len, pc, overflow = poa_tpu.assemble_votes(
            cv, iv, pc, cmol, clm, maxps, out_cols)
        return poa_tpu.merge_download(packed, out_len, overflow)

    specs = (P(None, data_axis), P(data_axis), P(data_axis), P(None, None),
             P(None))
    sharded = jax.shard_map(local, mesh=mesh, in_specs=specs,
                            out_specs=P(None, None), check_vma=False)
    return jax.jit(sharded, in_shardings=tuple(
        NamedSharding(mesh, s) for s in specs))
