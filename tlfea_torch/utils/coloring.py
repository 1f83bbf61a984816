"""Graph colouring for Vertex Block Descent (port of `tlfea/utils/coloring.py`).

Host-side NumPy: the reference's CPU utilities (`lib_utils/cpu_utils.h:18-57`:
BuildVertexAdjacency, GreedyVertexColoring, ValidateColoring,
BuildNodeIncidence, BuildColorToNodes) and the padding into static-shape
arrays. `colors_and_incidence` takes the g++ helper `tlfea_torch.native`
when it is built (about 100x faster at 100k elements), as
`tlfea/utils/coloring.py:24-42` does; both give the same first-fit colouring.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "build_adjacency",
    "greedy_coloring",
    "validate_coloring",
    "build_incidence",
    "pad_colors",
    "colors_and_incidence",
]


def colors_and_incidence(conn: np.ndarray, n_coef: int):
    """First-fit colouring and padded incidence lists -> (colors (n_coef,),
    inc (n_coef, max_inc, 2), inc_mask): the native helper when it is built,
    else this module's NumPy functions."""
    from tlfea_torch import native

    colors = native.greedy_color(conn, n_coef)
    if colors is None:
        return greedy_coloring(build_adjacency(conn, n_coef)), *build_incidence(conn, n_coef)
    return colors, *native.build_incidence(conn, n_coef)


def build_adjacency(conn: np.ndarray, n_coef: int) -> list[set[int]]:
    """Adjacency sets: coefficients are adjacent iff they share an element."""
    adj: list[set[int]] = [set() for _ in range(n_coef)]
    for row in np.asarray(conn).tolist():
        for a in row:
            adj[a].update(b for b in row if b != a)
    return adj


def greedy_coloring(adj: list[set[int]]) -> np.ndarray:
    """First-fit greedy colouring in natural node order -> (n_coef,) colors."""
    n = len(adj)
    colors = [-1] * n
    for v in range(n):
        used = {colors[u] for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return np.asarray(colors, dtype=np.int64)


def validate_coloring(adj: list[set[int]], colors: np.ndarray) -> bool:
    return all(colors[v] != colors[u] for v in range(len(adj)) for u in adj[v])


def build_incidence(conn: np.ndarray, n_coef: int):
    """Per-coefficient (element, local index) incidence lists ->
    (inc (n_coef, max_inc, 2) int32, inc_mask (n_coef, max_inc) bool),
    padded with (0, 0) where the mask is False."""
    lists: list[list[tuple[int, int]]] = [[] for _ in range(n_coef)]
    for e, row in enumerate(np.asarray(conn).tolist()):
        for a, node in enumerate(row):
            lists[node].append((e, a))
    max_inc = max((len(l) for l in lists), default=1) or 1
    inc = np.zeros((n_coef, max_inc, 2), dtype=np.int32)
    mask = np.zeros((n_coef, max_inc), dtype=bool)
    for i, l in enumerate(lists):
        if l:
            inc[i, : len(l)] = l
            mask[i, : len(l)] = True
    return inc, mask


def pad_colors(colors: np.ndarray, group_size: int):
    """Pack colours into (n_groups, group_size, max nodes per colour) arrays,
    the reference's conflict-free colour groups (`SyncedVBD.cu:950-996`):
    (nodes int32 padded with 0, mask bool)."""
    n_colors = int(colors.max()) + 1
    per_color = [np.nonzero(colors == c)[0] for c in range(n_colors)]
    max_nc = max(len(p) for p in per_color)
    n_groups = -(-n_colors // group_size)
    nodes = np.zeros((n_groups, group_size, max_nc), dtype=np.int32)
    mask = np.zeros((n_groups, group_size, max_nc), dtype=bool)
    for c, p in enumerate(per_color):
        g, s = divmod(c, group_size)
        nodes[g, s, : len(p)] = p
        mask[g, s, : len(p)] = True
    return nodes, mask
