"""BVH: construction, serialization, and vectorized traversal.

The reference ships only a *reader* for its prebuilt ``BVH_00.04`` binary
(staircase_scene.h:75–101); the builder lives in an unshipped project
(TODO.txt per SURVEY §2). Here we provide all three:

  * :func:`build_bvh` — our own builder (median split over the largest
    extent axis, matching the reference builder's reported strategy),
    producing the same *implicit complete binary heap* layout the kernels
    assume: nodes indexed from 1, ``first_leaf = num_nodes // 2``
    (kernels.cu:614), leaf ``i`` covering ``prims_per_leaf`` consecutive
    reordered triangles with sentinel padding (kernels.cu:199–203).
  * :func:`load_bvh_file` / :func:`save_bvh_file` — bit-compatible
    ``BVH_00.04`` serialization.
  * :func:`traverse` — the traversal, semantically the reference's
    DUAL_NODES variant (kernels.cu:148–224: load both children, near-first
    ordering by slab entry distance, bitstack backtracking via
    ``pop_bitstack`` kernels.cu:148), but *vectorized*: one
    ``lax.while_loop`` advances all N rays one traversal step per
    iteration with masked lane updates — no warps, no divergence, just
    dense vector ops + gathers.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pathtracer.models.scene import MeshData
from tpu_pathtracer.ops.intersect import bbox_hit_dist, triangles_hit
from tpu_pathtracer.ops.vec import FLT_MAX

_U32 = jnp.uint32

# Triangles per leaf for the large zoo meshes, OBJ files and the
# asset-scale staircase. traverse() tests a whole leaf for every lane on
# every step, so the width trades per-step work against step count. Set
# from chip_smoke.py's sweep of the 845k-triangle rock frame on an H100
# (PERF.md): width 8 ran 1.3x faster than 16 and 3.5x faster than 64.
MESH_LEAF_WIDTH = 8

# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              tex_coords: np.ndarray | None = None,
              mesh_id: np.ndarray | None = None,
              prims_per_leaf: int = 5,
              builder: str = "auto") -> MeshData:
    """Build an implicit-heap BVH over triangles (host-side, NumPy).

    ``builder``: "auto" uses the native binned-SAH builder when available
    (compiled on demand) and falls back to the NumPy median split; "sah" /
    "median" force one. Both orders render identically up to fp tie
    order.

    Median split: largest centroid-extent axis; the complete tree is
    packed left-first so every leaf except a right-edge tail is full.
    Triangle arrays are reordered and padded to ``num_leaves *
    prims_per_leaf`` with +inf sentinel triangles (the padding convention
    the traversal kernels rely on, kernels.cu:202).
    """
    native_build_order = None
    if builder in ("auto", "sah"):
        try:
            from tpu_pathtracer.native import native_build_order
        except Exception:  # pragma: no cover - native lib is optional
            native_build_order = None
        if builder == "sah" and native_build_order is None:
            raise RuntimeError("builder='sah' but the native builder "
                               "is unavailable")

    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]
    if tex_coords is None:
        tex_coords = np.zeros((T, 6), np.float32)
    if mesh_id is None:
        mesh_id = np.zeros((T,), np.int32)
    tex_coords = np.asarray(tex_coords, np.float32)
    mesh_id = np.asarray(mesh_id, np.int32)

    P = prims_per_leaf
    num_leaves = max(_next_pow2((T + P - 1) // P), 2)
    num_nodes = 2 * num_leaves

    centroids = (v0 + v1 + v2) / 3.0
    # slot assignment: slots[k] = original triangle index at padded slot k,
    # -1 for sentinel padding.
    slots = np.full(num_leaves * P, -1, np.int64)

    order = None
    if native_build_order is not None:
        tri_min = np.minimum(np.minimum(v0, v1), v2)
        tri_max = np.maximum(np.maximum(v0, v1), v2)
        order = native_build_order(tri_min, tri_max, num_leaves, P)
    if order is None:
        order = _median_order(centroids, num_leaves, P)
    slots[:] = order  # both builders return the padded slot layout

    # gather reordered + padded triangle arrays; sentinels get +inf verts
    def take(arr, fill):
        out = np.full((num_leaves * P,) + arr.shape[1:], fill, arr.dtype)
        mask = slots >= 0
        out[mask] = arr[slots[mask]]
        return out

    rv0 = take(v0, np.inf)
    rv1 = take(v1, np.inf)
    rv2 = take(v2, np.inf)
    rtc = take(tex_coords, 0.0)
    rmid = take(mesh_id, 0)

    bvh_min, bvh_max = _node_boxes(rv0, rv1, rv2, num_leaves, P)
    return MeshData(
        v0=jnp.asarray(rv0), v1=jnp.asarray(rv1), v2=jnp.asarray(rv2),
        tex_coords=jnp.asarray(rtc), mesh_id=jnp.asarray(rmid),
        bvh_min=jnp.asarray(bvh_min), bvh_max=jnp.asarray(bvh_max),
        bounds_min=jnp.asarray(bvh_min[1]), bounds_max=jnp.asarray(bvh_max[1]),
        first_leaf=num_leaves, prims_per_leaf=P,
    )


def _median_order(centroids: np.ndarray, num_leaves: int, P: int) -> np.ndarray:
    """Recursive median partition producing the padded slot order.

    Returns an int64 array of length num_leaves*P with original triangle
    indices, -1 marking empty slots. Left-packed: each internal split gives
    the left subtree ``min(len, capacity/2)`` triangles after sorting along
    the widest centroid axis.
    """
    out = np.full(num_leaves * P, -1, np.int64)

    # iterative stack to avoid recursion limits on deep trees
    stack = [(np.arange(centroids.shape[0], dtype=np.int64), 0, num_leaves)]
    while stack:
        idxs, leaf0, nl = stack.pop()
        if len(idxs) == 0:
            continue
        if nl == 1:
            out[leaf0 * P: leaf0 * P + len(idxs)] = idxs
            continue
        c = centroids[idxs]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        srt = idxs[np.argsort(c[:, axis], kind="stable")]
        half_cap = (nl // 2) * P
        take_left = min(len(srt), max((len(srt) + 1) // 2, len(srt) - half_cap))
        take_left = min(take_left, half_cap)
        stack.append((srt[:take_left], leaf0, nl // 2))
        stack.append((srt[take_left:], leaf0 + nl // 2, nl // 2))
    return out


def _node_boxes(v0, v1, v2, num_leaves: int, P: int):
    """Bottom-up box computation for the complete tree. Empty leaves get
    inverted boxes (min=+big, max=-big) that can never be hit."""
    num_nodes = 2 * num_leaves
    bvh_min = np.full((num_nodes, 3), 1e30, np.float32)
    bvh_max = np.full((num_nodes, 3), -1e30, np.float32)

    tri_min = np.minimum(np.minimum(v0, v1), v2).reshape(num_leaves, P, 3)
    tri_max = np.maximum(np.maximum(v0, v1), v2).reshape(num_leaves, P, 3)
    finite = np.isfinite(tri_min).all(-1) & np.isfinite(tri_max).all(-1)
    tri_min = np.where(finite[..., None], tri_min, 1e30)
    tri_max = np.where(finite[..., None], tri_max, -1e30)
    bvh_min[num_leaves:] = tri_min.min(axis=1)
    bvh_max[num_leaves:] = tri_max.max(axis=1)
    for i in range(num_leaves - 1, 0, -1):
        bvh_min[i] = np.minimum(bvh_min[2 * i], bvh_min[2 * i + 1])
        bvh_max[i] = np.maximum(bvh_max[2 * i], bvh_max[2 * i + 1])
    return bvh_min, bvh_max


# ---------------------------------------------------------------------------
# BVH_00.04 serialization (staircase_scene.h:75–101)
# ---------------------------------------------------------------------------

BVH_HEADER = b"BVH_00.04\x00"

# MSVC layout of `triangle` (helper_structs.h:81–96): 9 f32 verts + 6 f32
# texcoords + u8 meshID + 3 pad = 64 bytes.
_TRI_DTYPE = np.dtype([
    ("v", np.float32, (3, 3)),
    ("tc", np.float32, (6,)),
    ("mesh", np.uint8),
    ("pad", np.uint8, (3,)),
])
assert _TRI_DTYPE.itemsize == 64


def load_bvh_file(path: str) -> MeshData:
    """Read a reference-format ``.bvh`` scene binary into MeshData."""
    with open(path, "rb") as f:
        header = f.read(len(BVH_HEADER))
        if header != BVH_HEADER:
            raise ValueError(f"invalid header {header!r}")
        (num_tris,) = struct.unpack("<i", f.read(4))
        tris = np.frombuffer(f.read(num_tris * _TRI_DTYPE.itemsize), dtype=_TRI_DTYPE)
        (num_nodes,) = struct.unpack("<i", f.read(4))
        nodes = np.frombuffer(f.read(num_nodes * 24), dtype=np.float32).reshape(num_nodes, 6)
        bounds = np.frombuffer(f.read(24), dtype=np.float32)
        (ppl,) = struct.unpack("<i", f.read(4))

    first_leaf = num_nodes // 2  # kernels.cu:614
    # the traversal bitstack is uint32: one bit per level below the root
    # (kernels.cu:157); deeper trees would silently corrupt backtracking.
    depth = max(first_leaf, 1).bit_length()  # levels below root
    if depth > 32:
        raise ValueError(
            f"BVH depth {depth} exceeds the 32-level uint32 bitstack")
    # pad triangle arrays out to full leaf coverage with sentinels
    want = first_leaf * ppl
    v = tris["v"].astype(np.float32)
    tc = tris["tc"].astype(np.float32)
    mid = tris["mesh"].astype(np.int32)
    if want > num_tris:
        pad = want - num_tris
        v = np.concatenate([v, np.full((pad, 3, 3), np.inf, np.float32)])
        tc = np.concatenate([tc, np.zeros((pad, 6), np.float32)])
        mid = np.concatenate([mid, np.zeros((pad,), np.int32)])
    return MeshData(
        v0=jnp.asarray(v[:, 0]), v1=jnp.asarray(v[:, 1]), v2=jnp.asarray(v[:, 2]),
        tex_coords=jnp.asarray(tc), mesh_id=jnp.asarray(mid),
        bvh_min=jnp.asarray(nodes[:, 0:3]), bvh_max=jnp.asarray(nodes[:, 3:6]),
        bounds_min=jnp.asarray(bounds[0:3]), bounds_max=jnp.asarray(bounds[3:6]),
        first_leaf=first_leaf, prims_per_leaf=ppl,
    )


def save_bvh_file(path: str, mesh: MeshData) -> None:
    """Write MeshData as a reference-format ``.bvh`` binary."""
    T = mesh.num_tris
    mid_max = int(np.asarray(mesh.mesh_id).max(initial=0))
    if mid_max > 255:
        raise ValueError(
            f"mesh_id {mid_max} > 255 cannot round-trip through the "
            "reference's uint8 triangle meshID field (helper_structs.h:81)")
    tris = np.zeros(T, dtype=_TRI_DTYPE)
    tris["v"][:, 0] = np.asarray(mesh.v0)
    tris["v"][:, 1] = np.asarray(mesh.v1)
    tris["v"][:, 2] = np.asarray(mesh.v2)
    tris["tc"] = np.asarray(mesh.tex_coords)
    tris["mesh"] = np.asarray(mesh.mesh_id).astype(np.uint8)
    nodes = np.concatenate([np.asarray(mesh.bvh_min), np.asarray(mesh.bvh_max)],
                           axis=1).astype(np.float32)
    with open(path, "wb") as f:
        f.write(BVH_HEADER)
        f.write(struct.pack("<i", T))
        f.write(tris.tobytes())
        f.write(struct.pack("<i", nodes.shape[0]))
        f.write(nodes.tobytes())
        f.write(np.asarray(mesh.bounds_min, np.float32).tobytes())
        f.write(np.asarray(mesh.bounds_max, np.float32).tobytes())
        f.write(struct.pack("<i", mesh.prims_per_leaf))


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------


class TraceResult(NamedTuple):
    t: jnp.ndarray       # [N] closest hit (== t_max sentinel when missed)
    tri_id: jnp.ndarray  # [N] int32, -1 = miss
    u: jnp.ndarray       # [N] barycentric u
    v: jnp.ndarray       # [N] barycentric v
    # traversal telemetry (NUM_NODES_BOTH/SINGLE, kernels.cu:220-221):
    # total steps that descended into both / a single child. 0 on
    # non-traversal paths (brute force has no nodes).
    nodes_both: jnp.ndarray = jnp.int32(0)
    nodes_single: jnp.ndarray = jnp.int32(0)


def _ctz(x: jnp.ndarray) -> jnp.ndarray:
    """Count trailing zeros of uint32 (x != 0): __ffsll(x)-1, kernels.cu:149."""
    low = x & (jnp.uint32(0) - x)
    return jax.lax.population_count(low - _U32(1)).astype(jnp.int32)


def traverse(mesh: MeshData, origin: jnp.ndarray, direction: jnp.ndarray,
             t_min, t_max, is_shadow: bool = False) -> TraceResult:
    """Vectorized dual-node BVH traversal (semantics: kernels.cu:154–224).

    All N rays advance one step per ``while_loop`` iteration; lanes that
    finished idle (masked). Per step, internal-node lanes load both
    children and pick near-first; leaf lanes test ``prims_per_leaf``
    triangles; dead-end lanes pop the bitstack. Shadow rays terminate on
    the first hit (any-hit early-out, kernels.cu:207).
    """
    N = origin.shape[0]
    P = mesh.prims_per_leaf
    first_leaf = mesh.first_leaf
    if max(int(first_leaf), 1).bit_length() > 32:
        raise ValueError("BVH deeper than the 32-level uint32 bitstack")
    inv_dir = 1.0 / direction
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (N,))
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))

    def pop(bs, idx):
        """pop_bitstack, kernels.cu:148–152, masked for finished lanes."""
        m = jnp.where(bs > 0, _ctz(bs), 0)
        bs2 = (bs >> m.astype(_U32)) ^ _U32(1)
        idx2 = (idx >> m) ^ 1
        return bs2, idx2

    def cond(state):
        idx, *_ = state
        return jnp.any(idx > 0)

    def body(state):
        idx, bs, closest, tri_id, uu, vv, nb, nsg = state
        active = idx > 0
        is_leaf = active & (idx >= first_leaf)
        is_int = active & ~is_leaf

        # --- internal: load both children, near-first (kernels.cu:163–197)
        idx2 = jnp.where(is_int, idx << 1, 2)
        lmin = mesh.bvh_min[idx2]
        lmax = mesh.bvh_max[idx2]
        rmin = mesh.bvh_min[idx2 + 1]
        rmax = mesh.bvh_max[idx2 + 1]
        lhit = bbox_hit_dist(lmin, lmax, origin, inv_dir, closest)
        rhit = bbox_hit_dist(rmin, rmax, origin, inv_dir, closest)
        trav_l = lhit < closest
        trav_r = rhit < closest
        swap = (rhit < lhit).astype(jnp.int32)
        both = is_int & trav_l & trav_r
        single = is_int & (trav_l ^ trav_r)
        none = is_int & ~trav_l & ~trav_r
        child = idx2 + swap

        # --- leaf: test P consecutive triangles (kernels.cu:198–215)
        base = jnp.where(is_leaf, (idx - first_leaf) * P, 0)
        hit_any = jnp.zeros((N,), bool)
        for p in range(P):
            ti = base + p
            tt, tu, tv = triangles_hit(mesh.v0[ti], mesh.v1[ti], mesh.v2[ti],
                                       origin, direction, t_min, closest)
            won = is_leaf & (tt < closest)
            closest = jnp.where(won, tt, closest)
            tri_id = jnp.where(won, ti, tri_id)
            uu = jnp.where(won, tu, uu)
            vv = jnp.where(won, tv, vv)
            hit_any = hit_any | won

        # --- advance
        bs_p, idx_p = pop(bs, idx)
        go_pop = none | is_leaf
        go_child = both | single
        new_idx = jnp.where(go_child, child, jnp.where(go_pop, idx_p, idx))
        new_bs = jnp.where(both, (bs << _U32(1)) + _U32(1),
                           jnp.where(single, bs << _U32(1),
                                     jnp.where(go_pop, bs_p, bs)))
        if is_shadow:
            # any-hit early-out: kernels.cu:207
            new_idx = jnp.where(hit_any, 0, new_idx)
        nb = nb + jnp.sum(both, dtype=jnp.int32)
        nsg = nsg + jnp.sum(single, dtype=jnp.int32)
        return (new_idx, new_bs, closest, tri_id, uu, vv, nb, nsg)

    # inits derived from the input so carry varyance matches under shard_map
    zf = origin[:, 0] * 0.0
    zi = zf.astype(jnp.int32)
    zs = jnp.sum(zf).astype(jnp.int32)  # varying scalar zero
    init = (
        zi + 1,                          # idx = 1, kernels.cu:155
        zi.astype(_U32) + _U32(1),       # bitStack = 1, kernels.cu:157
        t_max_b + zf,                    # closest = t_max, kernels.cu:156
        zi - 1,
        zf,
        zf,
        zs,
        zs,
    )
    (_, _, closest, tri_id, uu, vv, nb, nsg) = jax.lax.while_loop(
        cond, body, init)
    return TraceResult(t=closest, tri_id=tri_id, u=uu, v=vv,
                       nodes_both=nb, nodes_single=nsg)


def traverse_single_node(mesh: MeshData, origin: jnp.ndarray,
                         direction: jnp.ndarray, t_min, t_max,
                         is_shadow: bool = False) -> TraceResult:
    """Vectorized SINGLE-node stackless traversal — the reference's
    compile-time alternative to DUAL_NODES (kernels.cu:227–294:
    direction-sign child ordering via the node's split axis + a
    down/up walk instead of the bitstack).

    Completeness port of the variant nothing selects in the as-built
    reference (its own history found dual-node 2x faster, TODO.txt:527
    — confirmed here: one box fetch per step but ~2x the steps).
    Hit results are traversal-order-independent, so t/tri_id/u/v are
    identical to :func:`traverse` (tested); only step counts differ —
    every down-step box test is tallied into ``nodes_single``
    (``nodes_both`` stays 0: this walk never fetches two nodes).

    The reference stores each node's split axis; our ``BVH_00.04``
    tables don't carry one, so it is re-derived per call as the axis
    of largest child-center separation — the median/SAH builders split
    on exactly that axis, and ANY consistent choice keeps the walk
    correct (ordering is a heuristic, membership is not).
    """
    N = origin.shape[0]
    P = mesh.prims_per_leaf
    first_leaf = mesh.first_leaf
    inv_dir = 1.0 / direction
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (N,))
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))

    # per-internal-node split axis from child-center separation
    centers = (mesh.bvh_min + mesh.bvh_max) * 0.5          # [Nn,3]
    li = jnp.arange(first_leaf, dtype=jnp.int32) * 2
    sep = jnp.abs(centers[jnp.minimum(li, 2 * first_leaf - 2)]
                  - centers[jnp.minimum(li + 1, 2 * first_leaf - 1)])
    axis = jnp.argmax(sep, axis=-1).astype(jnp.int32)      # [first_leaf]
    # near child bit per (node, ray): 1 when the ray travels negative
    # along the split axis (left child holds the lower coordinates)
    dir_neg = (direction < 0.0)                            # [N,3]

    def near_bit(p):
        ax = axis[jnp.minimum(p, first_leaf - 1)]
        return jnp.take_along_axis(dir_neg, ax[:, None],
                                   axis=1)[:, 0].astype(jnp.int32)

    def cond(state):
        idx, *_ = state
        return jnp.any(idx > 0)

    def body(state):
        idx, down, closest, tri_id, uu, vv, nsg = state
        active = idx > 0
        going_down = active & (down > 0)
        going_up = active & (down == 0)

        # ---- down: test THIS node's box (the single fetch per step)
        ii = jnp.where(going_down, idx, 1)
        bmin = mesh.bvh_min[ii]
        bmax = mesh.bvh_max[ii]
        bhit = bbox_hit_dist(bmin, bmax, origin, inv_dir, closest)
        hit = going_down & (bhit < closest)
        is_leaf = idx >= first_leaf
        desc = hit & ~is_leaf
        visit = hit & is_leaf

        # leaf triangle tests (same masked MT loop as traverse)
        base = jnp.where(visit, (idx - first_leaf) * P, 0)
        hit_any = jnp.zeros((N,), bool)
        for p in range(P):
            ti = base + p
            tt, tu, tv = triangles_hit(mesh.v0[ti], mesh.v1[ti],
                                       mesh.v2[ti], origin, direction,
                                       t_min, closest)
            won = visit & (tt < closest)
            closest = jnp.where(won, tt, closest)
            tri_id = jnp.where(won, ti, tri_id)
            uu = jnp.where(won, tu, uu)
            vv = jnp.where(won, tv, vv)
            hit_any = hit_any | won

        # ---- up: near child -> far sibling (down); far -> parent (up)
        parent = jnp.maximum(idx >> 1, 1)
        was_near = (idx & 1) == near_bit(parent)
        up_to_sib = going_up & was_near & (idx > 1)
        up_to_par = going_up & ~was_near & (idx > 1)
        up_done = going_up & (idx <= 1)

        # ---- advance
        child = idx * 2 + near_bit(jnp.where(desc, idx, 1))
        new_idx = jnp.where(desc, child,
                            jnp.where(up_to_sib, idx ^ 1,
                                      jnp.where(up_to_par, parent,
                                                jnp.where(up_done, 0,
                                                          idx))))
        # a box miss or a processed leaf flips this lane to "up" at the
        # SAME node; descending or moving to the far sibling goes down
        new_down = jnp.where(desc | up_to_sib, 1,
                             jnp.where(going_down & ~desc, 0, down))
        if is_shadow:
            new_idx = jnp.where(hit_any, 0, new_idx)
        nsg = nsg + jnp.sum(going_down, dtype=jnp.int32)
        return (new_idx, new_down, closest, tri_id, uu, vv, nsg)

    zf = origin[:, 0] * 0.0
    zi = zf.astype(jnp.int32)
    zs = jnp.sum(zf).astype(jnp.int32)
    init = (zi + 1, zi + 1, t_max_b + zf, zi - 1, zf, zf, zs)
    (_, _, closest, tri_id, uu, vv, nsg) = jax.lax.while_loop(
        cond, body, init)
    return TraceResult(t=closest, tri_id=tri_id, u=uu, v=vv,
                       nodes_both=jnp.int32(0) + zs, nodes_single=nsg)


def brute_force(mesh: MeshData, origin: jnp.ndarray, direction: jnp.ndarray,
                t_min, t_max) -> TraceResult:
    """No-BVH all-triangles scan (kernels.cu:307–321) — the slow oracle.

    Scans triangle chunks with a running min to bound the [N, T]
    intermediate.
    """
    N = origin.shape[0]
    T = mesh.num_tris
    chunk = 2048
    Tpad = ((T + chunk - 1) // chunk) * chunk

    def pad(a, fill):
        return jnp.concatenate(
            [a, jnp.full((Tpad - T,) + a.shape[1:], fill, a.dtype)], axis=0)

    v0 = pad(mesh.v0, jnp.inf).reshape(-1, chunk, 3)
    v1 = pad(mesh.v1, jnp.inf).reshape(-1, chunk, 3)
    v2 = pad(mesh.v2, jnp.inf).reshape(-1, chunk, 3)

    t_min = jnp.asarray(t_min, jnp.float32)
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))

    def step(carry, tris):
        closest, tri_id, uu, vv, base = carry
        c0, c1, c2 = tris
        tt, tu, tv = triangles_hit(
            c0[None, :, :], c1[None, :, :], c2[None, :, :],
            origin[:, None, :], direction[:, None, :],
            t_min, closest[:, None])
        j = jnp.argmin(tt, axis=1)
        tbest = jnp.take_along_axis(tt, j[:, None], axis=1)[:, 0]
        won = tbest < closest
        rows = jnp.arange(N)
        closest = jnp.where(won, tbest, closest)
        tri_id = jnp.where(won, base + j.astype(jnp.int32), tri_id)
        uu = jnp.where(won, tu[rows, j], uu)
        vv = jnp.where(won, tv[rows, j], vv)
        return (closest, tri_id, uu, vv, base + chunk), None

    zf = origin[:, 0] * 0.0
    init = (t_max_b + zf, zf.astype(jnp.int32) - 1, zf, zf, jnp.int32(0))
    (closest, tri_id, uu, vv, _), _ = jax.lax.scan(step, init, (v0, v1, v2))
    return TraceResult(t=closest, tri_id=tri_id, u=uu, v=vv)
