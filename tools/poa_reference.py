"""Independent partial-order-alignment reference (Lee 2002 — the
algorithm family spoa implements; reference utils/Consensus.java:219
shells to `spoa -r 2`).

spoa itself is not installable here (zero egress), so this is a from-
scratch graph POA used as the EXTERNAL anchor for the consensus accuracy
study: reads are aligned one at a time to a growing
partial-order graph with NW scoring (match +5 / mismatch -4 / gap -8 —
spoa defaults and the engine's scores), matches fuse into existing
nodes, mismatches/insertions add branch nodes, and the consensus is the
heaviest path (max summed edge weight). Simplification vs full POA:
mismatch nodes are not merged into aligned-node groups — bubbles carry
the same majority signal, but per-column substitution votes spread over
branch nodes (slightly conservative for the POA side).

Pure numpy; no dependence on sicelore_tpu.ops (that is the point).
"""
from __future__ import annotations

import numpy as np

MATCH, MISMATCH, GAP = 5, -4, -8
NEG = -(10 ** 9)


class PoaGraph:
    def __init__(self, seq: bytes):
        n = len(seq)
        self.base = list(seq)
        self.pred: list[list[int]] = [[] if i == 0 else [i - 1]
                                      for i in range(n)]
        self.edge_w: dict[tuple[int, int], int] = {
            (i - 1, i): 1 for i in range(1, n)}
        self.support = [1] * n
        self.starts = [0]
        self.ends = [n - 1]

    def topo_order(self) -> list[int]:
        n = len(self.base)
        indeg = [0] * n
        succ: list[list[int]] = [[] for _ in range(n)]
        for v in range(n):
            for u in self.pred[v]:
                succ[u].append(v)
                indeg[v] += 1
        order = [v for v in range(n) if indeg[v] == 0]
        i = 0
        while i < len(order):
            for w in succ[order[i]]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    order.append(w)
            i += 1
        return order

    def align_and_add(self, seq: bytes) -> None:
        """Global NW of `seq` against the graph; fuse the traceback."""
        m = len(seq)
        q = np.frombuffer(seq, np.uint8).astype(np.int32)
        order = self.topo_order()
        n = len(self.base)
        S = {}                      # node -> score row [m+1]
        ptr_op = {}                 # node -> op row (0 diag, 1 del, 2 ins)
        ptr_u = {}                  # node -> pred row
        row0 = GAP * np.arange(m + 1)     # virtual source
        for v in order:
            sub = np.where(q == self.base[v], MATCH, MISMATCH)
            preds = self.pred[v]
            if preds:
                stack = np.stack([S[u] for u in preds])
                bi = np.argmax(stack, axis=0)
                bp = stack[bi, np.arange(m + 1)]
                bu = np.asarray([preds[i] for i in bi.tolist()], np.int32)
            else:
                bp = row0
                bu = np.full(m + 1, -1, np.int32)
            diag = np.full(m + 1, NEG)
            diag[1:] = bp[:-1] + sub
            dele = bp + GAP
            rmd = np.maximum(diag, dele)
            opmd = np.where(diag >= dele, 0, 1).astype(np.int8)
            # insertion-run closure: row[i] = max_k<=i rmd[k] + (i-k)*GAP
            ar = np.arange(m + 1)
            t = np.maximum.accumulate(rmd - GAP * ar)
            row = np.maximum(rmd, t + GAP * ar)
            op = np.where(row > rmd, np.int8(2), opmd)
            S[v] = row
            ptr_op[v] = op
            ptr_u[v] = bu
        # best end node at i = m
        vend = max(self.ends, key=lambda v: S[v][m])
        # traceback: state (v, i) = best path from the virtual source to
        # node v (consumed) using i query chars; v = -1 is the source
        v, i = vend, m
        path = []                 # (op, node, q index)
        while v != -1:
            op = int(ptr_op[v][i])
            if op == 0:           # diag: consume node v + query char i-1
                path.append((0, v, i - 1))
                v, i = int(ptr_u[v][i - 1]), i - 1
            elif op == 1:         # deletion: consume node v only
                path.append((1, v, -1))
                v = int(ptr_u[v][i])
            else:                 # insertion: consume query char i-1
                path.append((2, v, i - 1))
                i -= 1
        # leading query chars never consumed by a node: insertions
        while i > 0:
            path.append((2, -1, i - 1))
            i -= 1
        path.reverse()
        # fuse into the graph
        prev = -1
        first = None
        for op, v, qi in path:
            if op == 0:
                c = int(q[qi])
                if self.base[v] == c:
                    node = v
                    self.support[v] += 1
                else:
                    node = self._new_node(c)
            elif op == 2:
                node = self._new_node(int(q[qi]))
            else:
                continue          # deletion: node not in the read's path
            if prev >= 0 and node != prev:
                self._add_edge(prev, node)
            if first is None:
                first = node
            prev = node
        if first is not None and first not in self.starts:
            self.starts.append(first)
        if prev >= 0 and prev not in self.ends:
            self.ends.append(prev)

    def _new_node(self, c: int) -> int:
        self.base.append(c)
        self.pred.append([])
        self.support.append(1)
        return len(self.base) - 1

    def _add_edge(self, u: int, v: int) -> None:
        if u not in self.pred[v]:
            self.pred[v].append(u)
        self.edge_w[(u, v)] = self.edge_w.get((u, v), 0) + 1

    def consensus(self) -> bytes:
        """Heaviest path by summed edge weight (spoa's consensus rule)."""
        order = self.topo_order()
        best = {v: (self.support[v], -1) for v in order}
        for v in order:
            for u in self.pred[v]:
                w = best[u][0] + self.edge_w.get((u, v), 0) \
                    + self.support[v]
                if w > best[v][0]:
                    best[v] = (w, u)
        vend = max(order, key=lambda v: best[v][0])
        out = []
        v = vend
        while v != -1:
            out.append(self.base[v])
            v = best[v][1]
        return bytes(reversed(out))


def poa_consensus(reads: list[bytes]) -> bytes:
    """spoa-style consensus of a molecule's reads (>= 1)."""
    if len(reads) == 1:
        return reads[0]
    if len(reads) == 2:
        return max(reads, key=len)
    g = PoaGraph(reads[0])
    for r in reads[1:]:
        g.align_and_add(r)
    return g.consensus()
