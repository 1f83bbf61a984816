"""Bandwidth-reducing node renumbering (host-side NumPy).

A copy of `tlfea/utils/reorder.py` (`rcm_order` :58, `apply_node_order`
:109, `bandwidth` :120, `best_order` :127). On the GPU the band no longer
sizes any kernel window, but it still sets how far apart the nodes of one
element lie in memory, so the element kernels' indexed loads and the node
reduce stay local; and renumbering identically keeps the port's runs
comparable to the reference's node for node.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "node_adjacency", "rcm_order", "apply_node_order", "bandwidth",
    "best_order",
]


def node_adjacency(conn: np.ndarray, n: int):
    """CSR (indptr, indices) of the node graph where two nodes are adjacent
    iff they share an element (element cliques)."""
    conn = np.asarray(conn, dtype=np.int64)
    E, S = conn.shape
    a = np.repeat(conn, S, axis=1).ravel()
    b = np.tile(conn, (1, S)).ravel()
    keep = a != b
    key = a[keep] * n + b[keep]
    key = np.unique(key)
    rows = key // n
    cols = (key % n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, cols


def rcm_order(conn: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation: perm[new] = old node index.

    BFS from a minimum-degree node per component, each layer sorted by
    degree, order reversed.
    """
    indptr, indices = node_adjacency(conn, n)
    deg = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # Deterministic component seeds: min degree, ties by index.
    seed_rank = np.lexsort((np.arange(n), deg))
    for seed in seed_rank:
        if visited[seed]:
            continue
        visited[seed] = True
        order[pos] = seed
        frontier = np.array([seed], dtype=np.int64)
        pos += 1
        while frontier.size:
            starts = indptr[frontier]
            counts = deg[frontier]
            total = int(counts.sum())
            if total == 0:
                break
            base = np.repeat(starts, counts)
            offs = np.arange(total) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            nbrs = indices[base + offs]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size == 0:
                break
            uniq, first = np.unique(nbrs, return_index=True)
            layer = uniq[np.lexsort((uniq, deg[uniq], first))]
            layer = layer[np.lexsort((layer, deg[layer]))]
            visited[layer] = True
            order[pos:pos + layer.size] = layer
            pos += layer.size
            frontier = layer
    assert pos == n
    return order[::-1].copy()


def apply_node_order(nodes: np.ndarray, conn: np.ndarray, perm: np.ndarray):
    """Renumber: returns (nodes[perm], conn relabeled so new[i] = old
    perm[i]). Fixed sets / loads derived AFTER this stay consistent."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return np.ascontiguousarray(nodes[perm]), inv[np.asarray(conn)].astype(
        np.asarray(conn).dtype
    )


def bandwidth(conn: np.ndarray) -> int:
    """Max node-index span within one element (a cheap band proxy)."""
    conn = np.asarray(conn)
    return int((conn.max(axis=1) - conn.min(axis=1)).max()) + 1


def best_order(nodes: np.ndarray, conn: np.ndarray) -> np.ndarray:
    """Band-minimizing permutation: the better of RCM and a lexicographic
    sort along the PCA axes of the node cloud (longest axis first), by
    measured `bandwidth`."""
    nodes = np.asarray(nodes, dtype=np.float64)
    cands = [rcm_order(conn, len(nodes))]
    centered = nodes - nodes.mean(axis=0)
    # PCA axes, longest first; lexsort wants least-significant key first.
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    proj = centered @ vt.T  # (n, 3), column 0 = longest axis
    cands.append(np.lexsort((proj[:, 2], proj[:, 1], proj[:, 0])))
    best, best_band = None, None
    for perm in cands:
        _, c2 = apply_node_order(nodes, conn, perm)
        b = bandwidth(c2)
        if best_band is None or b < best_band:
            best, best_band = perm, b
    return best
