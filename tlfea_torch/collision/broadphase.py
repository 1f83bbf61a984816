"""Broadphase over per-element AABBs (port of `tlfea/collision/broadphase.py`).

Sweep-and-prune with a fixed candidate window of K successors per element
in the sweep order, the exact dense cross-mesh test, and the two-level
(block, then element) cross-mesh test; all shapes are fixed by the setup,
and every capacity reports its overflow as a flag on the device instead of
dropping contacts silently. `compact_pairs` packs the valid candidates
into a fixed capacity for the narrowphase.

The neighbour set is a sorted int64 array of keys `(a << 32) | b` (a < b):
element ids are below 2^31, so the keys order as the JAX package's uint64
keys do, and `torch.iinfo(torch.int64).max` is the sentinel of an empty set.
Every sort is stable, as `jnp.argsort` is; the host setup is NumPy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "BroadphaseSetup",
    "BlockCross",
    "setup_broadphase",
    "setup_dense_cross",
    "setup_block_cross",
    "find_pairs",
    "find_pairs_dense",
    "find_pairs_block",
    "compact_pairs",
]

_SENTINEL = torch.iinfo(torch.int64).max


@dataclass(frozen=True)
class BroadphaseSetup:
    """Element and topology tables for the broadphase filters."""

    corners: torch.Tensor  # (E, 4) corner node ids, int64
    all_nodes: torch.Tensor  # (E, n_nodes_per_elem) for the AABB extent, int64
    mesh_ids: torch.Tensor  # (E,) int32
    neighbor_hashes: torch.Tensor  # (H,) sorted int64 keys of neighbour pairs
    window: int
    margin: float


def _neighbor_keys(conn: np.ndarray) -> np.ndarray:
    """Sorted int64 keys (a << 32) | b, a < b, of every pair of elements
    that share a node (the set `tlfea/collision/broadphase.py:62-74` builds
    with a dictionary of lists), or the sentinel alone when there is none."""
    E, S = conn.shape
    node = conn.reshape(-1).astype(np.int64)
    elem = np.repeat(np.arange(E, dtype=np.int64), S)
    order = np.lexsort((elem, node))
    node, elem = node[order], elem[order]
    keys = []
    for d in range(1, node.size):
        same = node[d:] == node[:-d]
        if not same.any():
            break
        a, b = elem[:-d][same], elem[d:][same]
        keys.append((np.minimum(a, b) << 32) | np.maximum(a, b))
    if not keys:
        return np.array([_SENTINEL], dtype=np.int64)
    return np.unique(np.concatenate(keys))


def setup_broadphase(conn: np.ndarray, mesh_ids: np.ndarray, window: int = 32,
                     margin: float = 0.0, device="cuda") -> BroadphaseSetup:
    """Host precompute (`broadphase.py:47-81`): the neighbour key set. Two
    elements are neighbours iff they share any node; such pairs are
    filtered from the self-collision candidates."""
    conn = np.asarray(conn)
    device = torch.device(device)
    return BroadphaseSetup(
        corners=torch.as_tensor(conn[:, :4].astype(np.int64), device=device),
        all_nodes=torch.as_tensor(conn.astype(np.int64), device=device),
        mesh_ids=torch.as_tensor(np.asarray(mesh_ids, dtype=np.int32), device=device),
        neighbor_hashes=torch.as_tensor(_neighbor_keys(conn), device=device),
        window=int(window),
        margin=float(margin),
    )


def _is_neighbor(bp: BroadphaseSetup, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: do elements a and b share a node (`broadphase.py:84-90`)."""
    a, b = a.long(), b.long()
    key = (torch.minimum(a, b) << 32) | torch.maximum(a, b)
    h = bp.neighbor_hashes
    pos = torch.searchsorted(h, key.reshape(-1)).clamp_max(h.shape[0] - 1)
    return (h[pos] == key.reshape(-1)).reshape(key.shape)


def _aabbs(bp: BroadphaseSetup, x: torch.Tensor):
    pts = x[bp.all_nodes]  # (E, S, 3)
    return pts.amin(dim=1) - bp.margin, pts.amax(dim=1) + bp.margin


def find_pairs(bp: BroadphaseSetup, x: torch.Tensor, enable_self_collision: bool = False):
    """Candidate pairs from the current node positions (`broadphase.py:
    93-152`): -> (pairs (E*K, 2) int32, valid (E*K,) bool, window_overflow
    bool tensor). The sweep runs along the axis with the largest spread of
    box centres; window_overflow means some element had more than K
    successors still open on that axis."""
    lo, hi = _aabbs(bp, x)
    centers = 0.5 * (lo + hi)
    axis = torch.argmax(centers.amax(dim=0) - centers.amin(dim=0))
    lo_key = torch.index_select(lo, 1, axis.reshape(1))[:, 0]
    hi_key = torch.index_select(hi, 1, axis.reshape(1))[:, 0]

    order = torch.argsort(lo_key, stable=True)
    lo_s, hi_s = lo[order], hi[order]
    lo_key_s, hi_key_s = lo_key[order], hi_key[order]
    E, K = lo.shape[0], bp.window

    i_idx = torch.arange(E, device=x.device)[:, None]
    j_idx = i_idx + torch.arange(1, K + 1, device=x.device)[None, :]  # (E, K)
    in_range = j_idx < E
    j_safe = j_idx.clamp_max(E - 1)

    x_overlap = lo_key_s[j_safe] <= hi_key_s[:, None]
    box_overlap = torch.all((lo_s[j_safe] <= hi_s[:, None, :])
                            & (hi_s[j_safe] >= lo_s[:, None, :]), dim=-1)
    valid = in_range & x_overlap & box_overlap
    window_overflow = torch.any(in_range[:, -1] & x_overlap[:, -1])

    ea = order[:, None].expand(E, K)
    eb = order[j_safe]
    same_mesh = bp.mesh_ids[ea] == bp.mesh_ids[eb]
    if enable_self_collision:
        valid = valid & ~(same_mesh & _is_neighbor(bp, ea, eb))
    else:
        valid = valid & ~same_mesh
    pairs = torch.stack([ea.reshape(-1), eb.reshape(-1)], dim=1).to(torch.int32)
    return pairs, valid.reshape(-1), window_overflow


def setup_dense_cross(conn: np.ndarray, mesh_ids: np.ndarray, device="cuda"):
    """Every cross-mesh element pair -> (P, 2) int32 on `device`, or None
    when there is none (`broadphase.py:155-179`)."""
    mesh_ids = np.asarray(mesh_ids)
    ids = np.unique(mesh_ids)
    blocks = []
    for i_ in range(len(ids)):
        for j_ in range(i_ + 1, len(ids)):
            ea = np.nonzero(mesh_ids == ids[i_])[0]
            eb = np.nonzero(mesh_ids == ids[j_])[0]
            A, B = np.meshgrid(ea, eb, indexing="ij")
            blocks.append(np.stack([A.reshape(-1), B.reshape(-1)], axis=1))
    if not blocks:
        return None
    return torch.as_tensor(np.concatenate(blocks, axis=0).astype(np.int32),
                           device=torch.device(device))


@dataclass(frozen=True)
class BlockCross:
    """Tables of the two-level cross-mesh broadphase (`broadphase.py:
    182-204`): elements in Morton order of their rest centroids, each mesh
    padded to whole blocks of B, and the cross-mesh block-pair list."""

    order_pad: torch.Tensor  # (nb*B,) int32 element id per padded slot
    pad_mask: torch.Tensor  # (nb*B,) bool, True for real elements
    block_pairs: torch.Tensor  # (NBP, 2) int32
    block: int
    n_blocks: int
    block_pair_cap: int


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit x/y/z integer coordinates into a 30-bit Morton key."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v
    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def setup_block_cross(conn: np.ndarray, mesh_ids: np.ndarray, rest_nodes: np.ndarray,
                      block: int = 64, block_pair_cap: int = 256,
                      device="cuda") -> BlockCross | None:
    """Host precompute for `find_pairs_block` (`broadphase.py:221-276`), or
    None for a scene of one mesh. The AABBs are taken from the current
    positions every step; the rest layout decides only how tight the
    blocks are."""
    conn = np.asarray(conn)
    mesh_ids = np.asarray(mesh_ids)
    rest_nodes = np.asarray(rest_nodes)
    ids = np.unique(mesh_ids)
    if len(ids) < 2:
        return None
    centers = rest_nodes[conn[:, :4]].mean(axis=1)
    span = centers.max(axis=0) - centers.min(axis=0)
    span[span == 0] = 1.0
    q = np.clip((centers - centers.min(axis=0)) / span * 1023.0, 0, 1023)
    keys = _morton3(q.astype(np.uint32))

    order_pad, pad_mask, mesh_block_ranges = [], [], []
    nb = 0
    for mid in ids:
        e = np.nonzero(mesh_ids == mid)[0]
        e = e[np.argsort(keys[e], kind="stable")]
        n_real = e.size
        n_b = -(-n_real // block)
        pad = n_b * block - n_real
        order_pad.append(np.concatenate([e, np.zeros(pad, dtype=e.dtype)]))
        pad_mask.append(np.concatenate([np.ones(n_real, bool), np.zeros(pad, bool)]))
        mesh_block_ranges.append((nb, nb + n_b))
        nb += n_b

    bpairs = []
    for i_ in range(len(ids)):
        for j_ in range(i_ + 1, len(ids)):
            a0, a1 = mesh_block_ranges[i_]
            b0, b1 = mesh_block_ranges[j_]
            A, B = np.meshgrid(np.arange(a0, a1), np.arange(b0, b1), indexing="ij")
            bpairs.append(np.stack([A.reshape(-1), B.reshape(-1)], axis=1))
    device = torch.device(device)
    return BlockCross(
        order_pad=torch.as_tensor(np.concatenate(order_pad).astype(np.int32), device=device),
        pad_mask=torch.as_tensor(np.concatenate(pad_mask), device=device),
        block_pairs=torch.as_tensor(np.concatenate(bpairs, axis=0).astype(np.int32),
                                    device=device),
        block=int(block),
        n_blocks=int(nb),
        block_pair_cap=int(block_pair_cap),
    )


def find_pairs_block(bp: BroadphaseSetup, blk: BlockCross, x: torch.Tensor):
    """Two-level cross-mesh candidate pairs (`broadphase.py:279-317`): ->
    (pairs (cap*B*B, 2) int32, valid, overflow), overflow when more than
    `block_pair_cap` block pairs survive the block-AABB test. Padded slots
    carry inverted AABBs and never overlap."""
    lo, hi = _aabbs(bp, x)
    B, nb, cap = blk.block, blk.n_blocks, blk.block_pair_cap
    big = torch.finfo(lo.dtype).max
    mask = blk.pad_mask[:, None]
    lo_p = torch.where(mask, lo[blk.order_pad], big)
    hi_p = torch.where(mask, hi[blk.order_pad], -big)
    lo_blk = lo_p.reshape(nb, B, 3)
    hi_blk = hi_p.reshape(nb, B, 3)
    lo_b = lo_blk.amin(dim=1)
    hi_b = hi_blk.amax(dim=1)

    a = blk.block_pairs[:, 0]
    b = blk.block_pairs[:, 1]
    bvalid = torch.all((lo_b[a] <= hi_b[b]) & (hi_b[a] >= lo_b[b]), dim=-1)
    bpair_c, bvalid_c, b_overflow = compact_pairs(blk.block_pairs, bvalid, cap)

    ba, bb = bpair_c[:, 0], bpair_c[:, 1]
    la, ha = lo_blk[ba], hi_blk[ba]  # (cap, B, 3)
    lb, hb = lo_blk[bb], hi_blk[bb]
    overlap = torch.all((la[:, :, None, :] <= hb[:, None, :, :])
                        & (ha[:, :, None, :] >= lb[:, None, :, :]), dim=-1)
    valid = overlap & bvalid_c[:, None, None]

    eids = blk.order_pad.reshape(nb, B)
    ea = eids[ba][:, :, None].expand(cap, B, B)
    eb = eids[bb][:, None, :].expand(cap, B, B)
    pairs = torch.stack([ea.reshape(-1), eb.reshape(-1)], dim=1)
    return pairs, valid.reshape(-1), b_overflow


def find_pairs_dense(bp: BroadphaseSetup, x: torch.Tensor, cross_pairs: torch.Tensor):
    """Exact AABB test over the cross-mesh pair list (`broadphase.py:
    320-332`): -> (pairs (P, 2), valid (P,), overflow=False)."""
    lo, hi = _aabbs(bp, x)
    a = cross_pairs[:, 0]
    b = cross_pairs[:, 1]
    valid = torch.all((lo[a] <= hi[b]) & (hi[a] >= lo[b]), dim=-1)
    return cross_pairs, valid, torch.zeros((), dtype=torch.bool, device=x.device)


def compact_pairs(pairs: torch.Tensor, valid: torch.Tensor, capacity: int):
    """The valid pairs packed into a fixed capacity, in their order
    (`broadphase.py:335-356`): -> (pairs (capacity, 2), valid (capacity,),
    overflow). A prefix sum gives each valid pair its slot; the invalid
    and the overflowing ones are written to a dump row at `capacity`,
    which is sliced away, so no two kept writes share a slot."""
    n_valid = valid.sum()
    slot = torch.where(valid, torch.cumsum(valid, 0) - 1, capacity).clamp_max(capacity)
    out = pairs.new_zeros((capacity + 1, 2))
    out.index_put_((slot,), pairs)
    out_valid = torch.arange(capacity, device=valid.device) < n_valid
    return out[:capacity], out_valid, n_valid > capacity
