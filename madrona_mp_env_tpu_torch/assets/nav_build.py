"""Navmesh construction from raw collision geometry (mini-Recast).

Offline NumPy re-implementation of the reference's Recast build pipeline
(reference src/nav/nav_build.cpp buildFromSourceObjects /
buildFromHeightfield; vendored Recast in src/nav/Recast*.cpp):

  1. mark walkable triangles (slope <= 45 deg,
     rcMarkWalkableTriangles call at nav_build.cpp:160)
  2. rasterize them into a column heightfield
     (cell = agentRadius/4, cell height = proneHeight,
     nav_build.cpp:139-148 / RecastRasterization.cpp)
  3. compact walkable floors with >= standHeight headroom
     (rcBuildCompactHeightfield call at nav_build.cpp:173)
  4. erode the walkable area by the agent radius
     (rcErodeWalkableArea, distance-transform threshold,
     nav_build.cpp:42-46; params nav_build.cpp:258-265:
     agentRadius + 1)
  5. watershed region partition over the eroded distance field with
     min/merge region area 10 (rcBuildDistanceField + rcBuildRegions)
  6. trace region contours on the cell grid and simplify them
     (rcBuildContours, maxSimplificationError = 1 cell,
     maxEdgeLen = 100)
  7. triangulate each contour (ear clipping) and greedily merge
     triangles into convex polys of <= 6 verts (rcBuildPolyMesh,
     navMaxVertsPerPoly nav/consts.hpp:7)

Output is vertices + polygons in the navmesh.bin layout
(tools/convert_assets.write_navmesh_polys) consumed by assets/navmesh.py,
so a map can be onboarded from its collision mesh alone — no pre-authored
walkable .obj needed.

This is an offline tool: clarity over speed, plain NumPy on the host.
The port keeps its own copy of the JAX package's module, line for line,
so that its tools import nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .. import consts

WALKABLE = 1
NULL_AREA = 0


@dataclass
class NavBuildParams:
    """Mirror of NavmeshBuildParams (nav_build.hpp:37-44) with the
    defaults of defaultBuildParams (nav_build.cpp:258-265)."""

    agent_radius: float = consts.agent_radius + 1.0
    min_region_area: int = 10  # cells
    merge_region_area: int = 10
    max_simplification_error: float = 1.0  # in cells
    max_edge_len: int = 100  # in cells
    max_walkable_slope_deg: float = 45.0  # rcMarkWalkableTriangles arg
    cell_size: Optional[float] = None  # default agentRadius / 4
    cell_height: Optional[float] = None  # default proneHeight
    walkable_height: Optional[float] = None  # default standHeight
    walkable_climb: Optional[float] = None  # default one cell_height


@dataclass
class NavBuildResult:
    verts: np.ndarray  # [V, 3] f32
    polys: List[np.ndarray]  # each [n<=6] i32 vert indices, CCW
    # diagnostic layers
    num_regions: int = 0


# ---------------------------------------------------------------------------
# 1-2. triangle rasterization into a column heightfield
# ---------------------------------------------------------------------------


def _walkable_tris(tri_verts: np.ndarray, max_slope_deg: float) -> np.ndarray:
    """Up-facing triangles within the slope limit (rcMarkWalkableTriangles:
    the SIGNED up component — downward-facing faces are never walkable)."""
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=1)
    nz = n[:, 2] / np.maximum(ln, 1e-20)
    return (ln > 1e-12) & (nz >= np.cos(np.radians(max_slope_deg)))


def _rasterize(tri_verts: np.ndarray, walkable: np.ndarray,
               bmin: np.ndarray, cs: float, ch: float,
               nx: int, ny: int, nz: int):
    """Rasterize triangles into per-column span bitmaps.

    Returns (solid [nx, ny, nz] bool, walk_top [nx, ny, nz] bool): solid
    marks occupied voxels; walk_top marks voxels whose TOP surface comes
    from a walkable triangle (area assignment like Recast's per-span
    area id from the triangle that produced the span's ceiling)."""
    solid = np.zeros((nx, ny, nz), bool)
    walk_top = np.zeros((nx, ny, nz), bool)

    for t in range(len(tri_verts)):
        v = tri_verts[t]
        lo = v.min(axis=0)
        hi = v.max(axis=0)
        ix0 = max(int((lo[0] - bmin[0]) / cs), 0)
        ix1 = min(int((hi[0] - bmin[0]) / cs) + 1, nx)
        iy0 = max(int((lo[1] - bmin[1]) / cs), 0)
        iy1 = min(int((hi[1] - bmin[1]) / cs) + 1, ny)
        if ix1 <= ix0 or iy1 <= iy0:
            continue

        # candidate cell centers
        cx = bmin[0] + (np.arange(ix0, ix1) + 0.5) * cs
        cy = bmin[1] + (np.arange(iy0, iy1) + 0.5) * cs
        gx, gy = np.meshgrid(cx, cy, indexing="ij")
        px = gx.reshape(-1)
        py = gy.reshape(-1)

        # conservative coverage: cell overlaps the tri's xy footprint if the
        # center is within half a cell diagonal of the triangle (cheap
        # point-in-expanded-tri via barycentric + edge distance)
        x0, y0 = v[0, 0], v[0, 1]
        e1x, e1y = v[1, 0] - x0, v[1, 1] - y0
        e2x, e2y = v[2, 0] - x0, v[2, 1] - y0
        den = e1x * e2y - e1y * e2x
        degenerate_2d = abs(den) < 1e-12
        if degenerate_2d:
            # vertical wall: treat footprint as the segment bbox cells
            inside = np.ones_like(px, bool)
            bu = np.zeros_like(px)
            bv = np.zeros_like(px)
        else:
            rx = px - x0
            ry = py - y0
            bu = (rx * e2y - ry * e2x) / den
            bv = (e1x * ry - e1y * rx) / den
            margin = 0.71 * cs / max(
                min(np.hypot(e1x, e1y), np.hypot(e2x, e2y)), 1e-9
            )
            inside = (bu >= -margin) & (bv >= -margin) & (bu + bv <= 1 + margin)
        if not inside.any():
            continue

        px, py = px[inside], py[inside]
        bu, bv = np.clip(bu[inside], 0, 1), np.clip(bv[inside], 0, 1)
        over = bu + bv
        scale = np.where(over > 1, 1.0 / np.maximum(over, 1e-9), 1.0)
        bu *= scale
        bv *= scale

        # z range across the cell: interpolated z at clamped barycentric
        # +/- the tri's z span within the cell (conservative: use tri z
        # bounds for walls, interpolated z for near-planar floors)
        z_at = v[0, 2] + bu * (v[1, 2] - v[0, 2]) + bv * (v[2, 2] - v[0, 2])
        z_lo = np.maximum(np.minimum(z_at - 0.5 * ch, hi[2]), lo[2])
        z_hi = np.minimum(np.maximum(z_at + 0.5 * ch, lo[2]), hi[2])
        if degenerate_2d:
            z_lo = np.full_like(px, lo[2])
            z_hi = np.full_like(px, hi[2])

        iz0 = np.clip(((z_lo - bmin[2]) / ch).astype(int), 0, nz - 1)
        iz1 = np.clip(((z_hi - bmin[2]) / ch).astype(int), 0, nz - 1)

        ixs = ((px - bmin[0]) / cs).astype(int)
        iys = ((py - bmin[1]) / cs).astype(int)
        ixs = np.clip(ixs, 0, nx - 1)
        iys = np.clip(iys, 0, ny - 1)
        w = bool(walkable[t])
        for k in range(len(px)):
            solid[ixs[k], iys[k], iz0[k]: iz1[k] + 1] = True
            if w:
                walk_top[ixs[k], iys[k], iz1[k]] = True
    return solid, walk_top


# ---------------------------------------------------------------------------
# 3. compact walkable floors
# ---------------------------------------------------------------------------


def _walkable_floors(solid: np.ndarray, walk_top: np.ndarray,
                     walkable_height_cells: int):
    """Per column: the LOWEST walkable floor voxel with enough headroom.

    Returns (floor_z [nx, ny] int, -1 where none). One span per column (the
    game's maps are single-storey arenas; Recast keeps span lists — stacked
    walkable layers over the same xy are a documented limitation). Taking
    the lowest floor keeps the ground level; isolated elevated surfaces
    (wall tops) still get their own span where no ground exists below, and
    the climb-limited connectivity disconnects them from the ground."""
    nx, ny, nz = solid.shape
    floor_z = np.full((nx, ny), -1, np.int32)

    # top surface of each solid run: solid[z] and not solid[z+1]
    above = np.zeros_like(solid)
    above[:, :, :-1] = solid[:, :, 1:]
    top = solid & ~above & walk_top

    for z in range(nz):
        cand = top[:, :, z]
        if not cand.any():
            continue
        zh = min(z + 1 + walkable_height_cells, nz)
        clear = ~solid[:, :, z + 1: zh]
        ok = cand & clear.all(axis=2) & (floor_z < 0)
        floor_z[ok] = z
    return floor_z


# ---------------------------------------------------------------------------
# 4-5. erosion + watershed regions
# ---------------------------------------------------------------------------


def _grid_distance(mask: np.ndarray) -> np.ndarray:
    """Chamfer distance (in cells, 2-pass 3x3) to the nearest ~mask cell.
    Recast's rcErodeWalkableArea / rcBuildDistanceField equivalent."""
    nx, ny = mask.shape
    INF = 1 << 20
    d = np.where(mask, INF, 0).astype(np.int64)
    # forward pass
    for x in range(nx):
        for y in range(ny):
            if d[x, y] == 0:
                continue
            best = d[x, y]
            if x > 0:
                best = min(best, d[x - 1, y] + 2)
                if y > 0:
                    best = min(best, d[x - 1, y - 1] + 3)
                if y < ny - 1:
                    best = min(best, d[x - 1, y + 1] + 3)
            if y > 0:
                best = min(best, d[x, y - 1] + 2)
            d[x, y] = best
    # backward pass
    for x in range(nx - 1, -1, -1):
        for y in range(ny - 1, -1, -1):
            if d[x, y] == 0:
                continue
            best = d[x, y]
            if x < nx - 1:
                best = min(best, d[x + 1, y] + 2)
                if y > 0:
                    best = min(best, d[x + 1, y - 1] + 3)
                if y < ny - 1:
                    best = min(best, d[x + 1, y + 1] + 3)
            if y < ny - 1:
                best = min(best, d[x, y + 1] + 2)
            d[x, y] = best
    return d  # scaled by 2 (chamfer)


def _neighbors4(x, y, nx, ny):
    if x > 0:
        yield x - 1, y
    if x < nx - 1:
        yield x + 1, y
    if y > 0:
        yield x, y - 1
    if y < ny - 1:
        yield x, y + 1


# direction order for conn4: 0=-x, 1=+x, 2=-y, 3=+y
_D4 = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _connectivity4(walk: np.ndarray, floor_z: np.ndarray,
                   climb_cells: int) -> np.ndarray:
    """conn4 [nx, ny, 4] bool: neighbor in direction d is walkable AND the
    floor step is within walkable_climb (rcConnectCompactHeightfieldNeighbors
    — a cliff edge is not a traversable edge)."""
    nx, ny = walk.shape
    conn = np.zeros((nx, ny, 4), bool)
    z = floor_z
    for d, (dx, dy) in enumerate(_D4):
        # source cells (x, y) with an in-bounds neighbor (x+dx, y+dy):
        # source slice s*, neighbor slice n*
        sx0, sx1 = max(0, -dx), nx + min(0, -dx)
        sy0, sy1 = max(0, -dy), ny + min(0, -dy)
        nx0, nx1 = max(0, dx), nx + min(0, dx)
        ny0, ny1 = max(0, dy), ny + min(0, dy)
        ok = (
            walk[sx0:sx1, sy0:sy1]
            & walk[nx0:nx1, ny0:ny1]
            & (np.abs(z[sx0:sx1, sy0:sy1] - z[nx0:nx1, ny0:ny1])
               <= climb_cells)
        )
        conn[sx0:sx1, sy0:sy1, d] = ok
    return conn


def _conn_ok(conn4, x, y, xx, yy):
    for d, (dx, dy) in enumerate(_D4):
        if xx - x == dx and yy - y == dy:
            return bool(conn4[x, y, d])
    return False


def _components(walk: np.ndarray, conn4: np.ndarray) -> np.ndarray:
    """Connected components under climb-limited connectivity.
    Returns comp id grid (0 = not walkable)."""
    nx, ny = walk.shape
    comp = np.zeros((nx, ny), np.int32)
    next_id = 1
    for x, y in np.argwhere(walk):
        if comp[x, y] != 0:
            continue
        stack = [(int(x), int(y))]
        comp[x, y] = next_id
        while stack:
            cx, cy = stack.pop()
            for d, (dx, dy) in enumerate(_D4):
                if not conn4[cx, cy, d]:
                    continue
                xx, yy = cx + dx, cy + dy
                if comp[xx, yy] == 0:
                    comp[xx, yy] = next_id
                    stack.append((xx, yy))
        next_id += 1
    return comp


def _watershed_regions(walk: np.ndarray, dist: np.ndarray, conn4: np.ndarray,
                       min_area: int, merge_area: int) -> np.ndarray:
    """Flood regions from distance-field peaks downward (rcBuildRegions'
    watershed, simplified), then merge/filter small regions.

    Returns region id grid [nx, ny] (0 = no region)."""
    nx, ny = walk.shape
    region = np.zeros((nx, ny), np.int32)
    next_region = 1

    order = np.argsort(-dist[walk].reshape(-1), kind="stable")
    cells = np.argwhere(walk)[order]
    # the cells of one level are a run of the sorted order, in argwhere
    # order within it: a level's frontier is read off its run
    sorted_dist = dist[walk].reshape(-1)[order]
    run_start = np.flatnonzero(
        np.r_[True, sorted_dist[1:] != sorted_dist[:-1]])
    runs = np.split(cells, run_start[1:])

    levels = np.unique(dist[walk])[::-1]
    assert len(runs) == len(levels)
    for level, run in zip(levels, runs):
        # expand existing regions into cells at this level first
        frontier = [(x, y) for x, y in run if region[x, y] == 0]
        changed = True
        while changed:
            changed = False
            for x, y in frontier:
                if region[x, y] != 0:
                    continue
                for d, (dx, dy) in enumerate(_D4):
                    if not conn4[x, y, d]:
                        continue
                    xx, yy = x + dx, y + dy
                    if region[xx, yy] != 0 and dist[xx, yy] >= level:
                        region[x, y] = region[xx, yy]
                        changed = True
                        break
        # remaining cells at this level seed new regions (BFS per seed)
        for x, y in frontier:
            if region[x, y] != 0:
                continue
            rid = next_region
            next_region += 1
            stack = [(int(x), int(y))]
            region[x, y] = rid
            while stack:
                cx, cy = stack.pop()
                for d, (dx, dy) in enumerate(_D4):
                    if not conn4[cx, cy, d]:
                        continue
                    xx, yy = cx + dx, cy + dy
                    if (
                        walk[xx, yy] and region[xx, yy] == 0
                        and dist[xx, yy] == level
                    ):
                        region[xx, yy] = rid
                        stack.append((xx, yy))

    # merge small regions into their largest neighbor (rcMergeAndFilter)
    def region_sizes():
        return np.bincount(region.reshape(-1), minlength=next_region)

    sizes = region_sizes()
    for rid in range(1, next_region):
        if sizes[rid] == 0 or sizes[rid] >= merge_area:
            continue
        # find neighboring regions
        mask = region == rid
        neigh = set()
        for x, y in np.argwhere(mask):
            for d, (dx, dy) in enumerate(_D4):
                if not conn4[x, y, d]:
                    continue
                r2 = region[x + dx, y + dy]
                if r2 != 0 and r2 != rid:
                    neigh.add(r2)
        if neigh:
            target = max(neigh, key=lambda r: sizes[r])
            region[mask] = target
            sizes = region_sizes()

    # drop isolated regions below min area
    sizes = region_sizes()
    for rid in range(1, next_region):
        if 0 < sizes[rid] < min_area:
            region[region == rid] = 0

    # compact ids
    ids = np.unique(region)
    remap = np.zeros(ids.max() + 1, np.int32)
    for new, old in enumerate(ids):
        remap[old] = new
    return remap[region]


# ---------------------------------------------------------------------------
# 6. contour tracing + simplification
# ---------------------------------------------------------------------------


def _trace_contours(region: np.ndarray, conn4: np.ndarray) -> List[Tuple[int, List[Tuple[int, int, int]]]]:
    """Marching-squares walk of each region's outer boundary on the cell
    grid. Returns [(region_id, [(cx, cy, neighbor_region), ...])] with
    contour points at cell CORNERS, CCW, each edge tagged with the region
    on its other side (0 across unconnected/cliff edges) for vertex welding
    between adjacent regions."""
    nx, ny = region.shape
    # map walk-direction -> conn4 direction index (_D4 order: -x,+x,-y,+y)
    CONN_D = {(-1, 0): 0, (1, 0): 1, (0, -1): 2, (0, 1): 3}
    out = []
    for rid in np.unique(region):
        if rid == 0:
            continue
        mask = region == rid
        # find a starting boundary edge: cell in region with -x neighbor out
        start = None
        for x, y in np.argwhere(mask):
            if x == 0 or not mask[x - 1, y]:
                start = (int(x), int(y))
                break
        if start is None:
            continue

        # edge-walk: state = (cell, direction of the wall on its left)
        # directions: 0=-x, 1=+y, 2=+x, 3=-y; corner emitted per wall edge
        DIRS = [(-1, 0), (0, 1), (1, 0), (0, -1)]
        # corner at the START of the wall in walk order (CCW around region)
        CORNER = {0: (0, 0), 1: (0, 1), 2: (1, 1), 3: (1, 0)}

        def wall(x, y, d):
            xx, yy = x + DIRS[d][0], y + DIRS[d][1]
            if xx < 0 or xx >= nx or yy < 0 or yy >= ny:
                return True, 0
            if not conn4[x, y, CONN_D[DIRS[d]]]:
                return True, 0  # cliff/unconnected edge is a hard wall
            return (not mask[xx, yy]), int(region[xx, yy])

        x, y = start
        d = 0
        pts: List[Tuple[int, int, int]] = []
        state0 = (x, y, d)
        while True:
            is_wall, other = wall(x, y, d)
            if is_wall:
                cx, cy = CORNER[d]
                pts.append((x + cx, y + cy, other))
                d = (d + 1) % 4  # turn right (stay on boundary, CCW)
            else:
                # move into the open neighbor, turn left
                x, y = x + DIRS[d][0], y + DIRS[d][1]
                d = (d - 1) % 4
            if (x, y, d) == state0:
                break
            if len(pts) > 8 * nx * ny:
                break  # safety
        if len(pts) >= 3:
            out.append((int(rid), pts))
    return out


def _simplify_contour(pts: List[Tuple[int, int, int]], max_err: float,
                      max_edge: int) -> List[Tuple[int, int, int]]:
    """Recast-style simplification: keep points where the neighbor region
    changes (portal boundaries must stay welded), then Douglas-Peucker the
    spans in between; finally split edges longer than max_edge."""
    n = len(pts)
    keep = []
    for i in range(n):
        if pts[i][2] != pts[(i - 1) % n][2]:
            keep.append(i)
    if not keep:
        # closed loop with uniform neighbor: keep extremes
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        keep = sorted({
            int(np.argmin(xs)), int(np.argmax(xs)),
            int(np.argmin(ys)), int(np.argmax(ys)),
        })

    def seg_dp(i0, i1):
        """Douglas-Peucker over the open span pts(i0..i1) (cyclic)."""
        span = []
        j = i0
        while j != i1:
            span.append(j)
            j = (j + 1) % n
        span.append(i1)
        if len(span) <= 2:
            return []
        ax, ay = pts[i0][0], pts[i0][1]
        bx, by = pts[i1][0], pts[i1][1]
        dx, dy = bx - ax, by - ay
        L = max(np.hypot(dx, dy), 1e-9)
        best, bi = -1.0, -1
        for j in span[1:-1]:
            px, py = pts[j][0], pts[j][1]
            d = abs((px - ax) * dy - (py - ay) * dx) / L
            if d > best:
                best, bi = d, j
        if best > max_err:
            return seg_dp(i0, bi) + [bi] + seg_dp(bi, i1)
        # max edge split
        if L > max_edge:
            mid = span[len(span) // 2]
            return [mid]
        return []

    out_idx = []
    k = len(keep)
    for a in range(k):
        i0, i1 = keep[a], keep[(a + 1) % k]
        out_idx.append(i0)
        out_idx.extend(sorted(seg_dp(i0, i1), key=lambda j: (j - i0) % n))
    return [pts[i] for i in out_idx]


# ---------------------------------------------------------------------------
# 7. triangulate + merge to convex polys
# ---------------------------------------------------------------------------


def _area2(a, b, c):
    return (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])


def _ear_clip(poly: List[int], verts2d: np.ndarray) -> List[Tuple[int, int, int]]:
    """Ear-clipping triangulation of a simple CCW polygon (indices into
    verts2d). Returns triangle index triples."""
    idx = list(poly)
    tris = []
    guard = 0
    while len(idx) > 3 and guard < 10000:
        guard += 1
        n = len(idx)
        clipped = False
        for i in range(n):
            a, b, c = idx[(i - 1) % n], idx[i], idx[(i + 1) % n]
            if _area2(verts2d[a], verts2d[b], verts2d[c]) <= 0:
                continue
            # no other vertex inside
            ok = True
            for j in idx:
                if j in (a, b, c):
                    continue
                p = verts2d[j]
                if (
                    _area2(verts2d[a], verts2d[b], p) >= 0
                    and _area2(verts2d[b], verts2d[c], p) >= 0
                    and _area2(verts2d[c], verts2d[a], p) >= 0
                ):
                    ok = False
                    break
            if ok:
                tris.append((a, b, c))
                idx.pop(i)
                clipped = True
                break
        if not clipped:
            # fallback: fan (degenerate/collinear contours)
            for i in range(1, len(idx) - 1):
                tris.append((idx[0], idx[i], idx[i + 1]))
            return tris
    if len(idx) == 3:
        tris.append((idx[0], idx[1], idx[2]))
    return tris


def _merge_polys(tris: List[Tuple[int, ...]], verts2d: np.ndarray,
                 max_verts: int = 6) -> List[List[int]]:
    """Greedy shared-edge merge of triangles into convex polygons with at
    most max_verts vertices (rcBuildPolyMesh's merge step)."""
    polys = [list(t) for t in tris]

    def shared_edge(p, q):
        np_, nq = len(p), len(q)
        for i in range(np_):
            a, b = p[i], p[(i + 1) % np_]
            for j in range(nq):
                if q[j] == b and q[(j + 1) % nq] == a:
                    return i, j
        return None

    def merged(p, q, i, j):
        np_, nq = len(p), len(q)
        out = [p[(i + 1 + k) % np_] for k in range(np_ - 1)]
        out += [q[(j + 1 + k) % nq] for k in range(nq - 1)]
        return out

    def convex(p):
        n = len(p)
        for i in range(n):
            if _area2(
                verts2d[p[i]], verts2d[p[(i + 1) % n]],
                verts2d[p[(i + 2) % n]],
            ) < 0:
                return False
        return True

    improved = True
    while improved:
        improved = False
        best = None  # (edge_len, pi, qi, merged_poly)
        for pi in range(len(polys)):
            for qi in range(pi + 1, len(polys)):
                if len(polys[pi]) + len(polys[qi]) - 2 > max_verts:
                    continue
                se = shared_edge(polys[pi], polys[qi])
                if se is None:
                    continue
                m = merged(polys[pi], polys[qi], *se)
                if len(set(m)) != len(m) or not convex(m):
                    continue
                a = verts2d[polys[pi][se[0]]]
                b = verts2d[polys[pi][(se[0] + 1) % len(polys[pi])]]
                elen = float(np.hypot(b[0] - a[0], b[1] - a[1]))
                if best is None or elen > best[0]:
                    best = (elen, pi, qi, m)
        if best is not None:
            _, pi, qi, m = best
            polys[pi] = m
            polys.pop(qi)
            improved = True
    return polys


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def build_navmesh(tri_verts: np.ndarray,
                  params: Optional[NavBuildParams] = None,
                  keep_seeds: Optional[np.ndarray] = None) -> NavBuildResult:
    """Collision triangle soup [T, 3, 3] -> navmesh (verts + convex polys).

    The full reference pipeline (nav_build.cpp buildNavmeshFromSourceObjects
    -> buildFromHeightfield), single-storey: one walkable floor per column
    (Recast keeps span lists; the game's maps are arenas with no stacked
    walkable layers over the same xy).

    keep_seeds: optional [S, 3] points (e.g. spawn positions). When given,
    walkable components not reachable from any seed are pruned — sealed
    geometry interiors and isolated surfaces (wall tops) otherwise mesh as
    disconnected islands, exactly as vanilla Recast emits them."""
    p = params or NavBuildParams()
    tv = np.asarray(tri_verts, np.float64)
    if len(tv) == 0:
        return NavBuildResult(np.zeros((0, 3), np.float32), [])

    cs = p.cell_size or consts.agent_radius / 4.0
    ch = p.cell_height or consts.prone_height
    wh = p.walkable_height or consts.stand_height

    lo = tv.reshape(-1, 3).min(axis=0) - cs
    hi = tv.reshape(-1, 3).max(axis=0) + cs
    nx = int(np.ceil((hi[0] - lo[0]) / cs))
    ny = int(np.ceil((hi[1] - lo[1]) / cs))
    nz = int(np.ceil((hi[2] - lo[2]) / ch)) + int(np.ceil(wh / ch)) + 1
    bmin = lo

    walkable = _walkable_tris(tv, p.max_walkable_slope_deg)
    solid, walk_top = _rasterize(tv, walkable, bmin, cs, ch, nx, ny, nz)
    wh_cells = int(np.ceil(wh / ch))
    floor_z = _walkable_floors(solid, walk_top, wh_cells)
    walk = floor_z >= 0

    # connectivity: steps over walkable_climb (default one cell height,
    # rcBuildCompactHeightfield(standHeight, 1, ...) nav_build.cpp:173)
    # are cliffs, not traversable edges
    climb_cells = int(
        np.ceil((p.walkable_climb or ch) / ch)
    )
    conn4 = _connectivity4(walk, floor_z, climb_cells)
    comp = _components(walk, conn4)

    # erode by agent radius PER COMPONENT (chamfer distance is 2x cell
    # units): a disconnected surface (e.g. a wall top) is an obstacle for
    # the ground component, so the ground erodes away from wall footprints
    erode_cells = int(np.ceil(p.agent_radius / cs))
    eroded = np.zeros_like(walk)
    for cid in range(1, int(comp.max()) + 1):
        mask_c = comp == cid
        if not mask_c.any():
            continue
        dist_c = _grid_distance(mask_c)
        eroded |= mask_c & (dist_c >= 2 * erode_cells)
    walk = eroded

    # seed-reachability pruning (see docstring)
    if keep_seeds is not None and walk.any():
        seeds = np.asarray(keep_seeds, np.float64).reshape(-1, 3)
        six = np.clip(((seeds[:, 0] - bmin[0]) / cs).astype(int), 0, nx - 1)
        siy = np.clip(((seeds[:, 1] - bmin[1]) / cs).astype(int), 0, ny - 1)
        keep_ids = set()
        for sx, sy in zip(six, siy):
            # nearest surviving walk cell within a small search window
            if walk[sx, sy]:
                keep_ids.add(int(comp[sx, sy]))
                continue
            win = 8
            xs = slice(max(0, sx - win), min(nx, sx + win + 1))
            ys = slice(max(0, sy - win), min(ny, sy + win + 1))
            sub = np.argwhere(walk[xs, ys])
            if len(sub):
                d2 = ((sub[:, 0] + xs.start - sx) ** 2
                      + (sub[:, 1] + ys.start - sy) ** 2)
                bx, by = sub[np.argmin(d2)]
                keep_ids.add(int(comp[bx + xs.start, by + ys.start]))
        if keep_ids:
            keep_mask = np.isin(comp, sorted(keep_ids))
            walk = walk & keep_mask

    if not walk.any():
        return NavBuildResult(np.zeros((0, 3), np.float32), [])
    conn4 = conn4 & walk[:, :, None]
    for d, (dx, dy) in enumerate(_D4):
        nbr_ok = np.zeros_like(walk)
        sx0, sx1 = max(0, -dx), nx + min(0, -dx)
        sy0, sy1 = max(0, -dy), ny + min(0, -dy)
        nx0, nx1 = max(0, dx), nx + min(0, dx)
        ny0, ny1 = max(0, dy), ny + min(0, dy)
        nbr_ok[sx0:sx1, sy0:sy1] = walk[nx0:nx1, ny0:ny1]
        conn4[:, :, d] &= nbr_ok

    dist = _grid_distance(walk)
    region = _watershed_regions(
        walk, dist, conn4, p.min_region_area, p.merge_region_area
    )
    nreg = int(region.max())
    if nreg == 0:
        return NavBuildResult(np.zeros((0, 3), np.float32), [], 0)

    contours = _trace_contours(region, conn4)

    # weld: corner -> vertex id (shared between adjacent regions)
    vert_ids = {}
    verts = []

    # floor height at a corner: max floor among the up-to-4 touching cells
    # OF THE TRACED REGION (Recast getCornerHeight; restricting to the
    # region keeps cliff-separated spans — e.g. wall tops — from leaking
    # their height into ground-level boundary verts)
    def corner_z(cx, cy, rid):
        zs = []
        for xx in (cx - 1, cx):
            for yy in (cy - 1, cy):
                if (
                    0 <= xx < nx and 0 <= yy < ny
                    and region[xx, yy] == rid and floor_z[xx, yy] >= 0
                ):
                    zs.append(floor_z[xx, yy])
        z_cell = max(zs) if zs else 0
        return bmin[2] + (z_cell + 1) * ch

    def vid(cx, cy, rid):
        key = (cx, cy)
        if key not in vert_ids:
            vert_ids[key] = len(verts)
            verts.append((
                bmin[0] + cx * cs, bmin[1] + cy * cs,
                corner_z(cx, cy, rid),
            ))
        return vert_ids[key]

    polys: List[List[int]] = []
    for rid, pts in contours:
        simp = _simplify_contour(
            pts, p.max_simplification_error, p.max_edge_len
        )
        if len(simp) < 3:
            continue
        ids = []
        for cx, cy, _other in simp:
            v = vid(cx, cy, rid)
            if not ids or (v != ids[-1] and v != ids[0]):
                ids.append(v)
        if len(ids) < 3:
            continue
        v2d = np.asarray([(verts[i][0], verts[i][1]) for i in range(len(verts))])
        # ensure CCW
        area = 0.0
        for i in range(len(ids)):
            a = v2d[ids[i]]
            b = v2d[ids[(i + 1) % len(ids)]]
            area += a[0] * b[1] - b[0] * a[1]
        if area < 0:
            ids = ids[::-1]
        tris = _ear_clip(ids, v2d)
        tris = [t for t in tris if _area2(v2d[t[0]], v2d[t[1]], v2d[t[2]]) > 1e-9]
        polys.extend(_merge_polys(tris, v2d, max_verts=6))

    # drop unused verts + remap
    used = sorted({i for poly in polys for i in poly})
    remap = {old: new for new, old in enumerate(used)}
    verts_out = np.asarray([verts[i] for i in used], np.float32)
    polys_out = [np.asarray([remap[i] for i in poly], np.int32)
                 for poly in polys]
    return NavBuildResult(verts_out, polys_out, nreg)


def result_to_tris(res: NavBuildResult) -> Tuple[np.ndarray, np.ndarray]:
    """Fan-triangulate the poly mesh -> (verts [V,3] f32, tris [T,3] u32),
    the layout assets/navmesh.py consumes."""
    tris = []
    for poly in res.polys:
        for k in range(1, len(poly) - 1):
            tris.append((poly[0], poly[k], poly[k + 1]))
    return res.verts, np.asarray(tris, np.uint32).reshape(-1, 3)
