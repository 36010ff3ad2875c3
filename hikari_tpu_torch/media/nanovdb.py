"""NanoVDB FP32 grid I/O: a binary-compatible reader and writer (host numpy).

Port of ``hikari_tpu/media/nanovdb.py``: the same zlib-compressed NanoVDB
in-memory layout (GridData 672 B, TreeData 64 B, leaf 8^3 / lower 16^3 /
upper 32^3 / root nodes, pbrt-v4 compatible offsets), so a file written by
either package reads back in the other byte for byte. ``to_dense``
materialises the sparse tree into a dense density grid (a GridMedium);
``to_bricks`` reindexes it into the sparse brick layout of
``BrickGridMedium`` (active 8^3 leaves as bricks under an int32 page table)
without materialising the dense extent. Active constant root and internal
tiles become filled regions (clipped to the root index bbox) or shared
constant bricks.
"""

from __future__ import annotations

import zlib

import numpy as np

GRIDDATA_SIZE = 672
TREEDATA_SIZE = 64
MAP_OFFSET = 296
MAP_INVMAT = MAP_OFFSET + 36
MAP_VEC = MAP_OFFSET + 72
WORLDBBOX = 560
TREE_NODE_OFFSETS = GRIDDATA_SIZE          # 4 x u64: leaf, lower, upper, root
TREE_NODE_COUNTS = GRIDDATA_SIZE + 32      # 3 x u32

LEAF_DIM = 8
LEAF_SIZE = 2144
LEAF_MASK_OFF = 16
LEAF_VALUES_OFF = 96

LOWER_DIM = 16
LOWER_VALUEMASK_OFF = 32
LOWER_CHILDMASK_OFF = 544
LOWER_TABLE_OFF = 1088
LOWER_NODE_SIZE = LOWER_TABLE_OFF + 4096 * 8   # 33856

UPPER_DIM = 32
UPPER_VALUEMASK_OFF = 32
UPPER_CHILDMASK_OFF = 4128
UPPER_TABLE_OFF = 8256
UPPER_NODE_SIZE = UPPER_TABLE_OFF + 32768 * 8  # 270400

ROOT_HEADER = 64
ROOT_TILE = 32
UPPER_TOTAL = 12  # voxels per upper node per axis = 2^12


def _u32(b, off):
    return int(np.frombuffer(b, np.uint32, 1, off)[0])


def _u64(b, off):
    return int(np.frombuffer(b, np.uint64, 1, off)[0])


def _i64(b, off):
    return int(np.frombuffer(b, np.int64, 1, off)[0])


def _f32(b, off, n=1):
    return np.frombuffer(b, np.float32, n, off)


def extract_metadata(buf: bytes) -> dict:
    """GridData/TreeData header fields (extract_nanovdb_metadata)."""
    wb = np.frombuffer(buf, np.float64, 6, WORLDBBOX)
    inv_mat = _f32(buf, MAP_INVMAT, 9).reshape(3, 3)
    vec = _f32(buf, MAP_VEC, 3)
    offs = [_u64(buf, TREE_NODE_OFFSETS + 8 * i) for i in range(4)]
    counts = [_u32(buf, TREE_NODE_COUNTS + 4 * i) for i in range(3)]
    # node offsets are relative to TreeData start
    base = GRIDDATA_SIZE
    return dict(
        world_min=wb[:3], world_max=wb[3:],
        inv_mat=inv_mat, vec=vec,
        leaf_offset=base + offs[0], lower_offset=base + offs[1],
        upper_offset=base + offs[2], root_offset=base + offs[3],
        leaf_count=counts[0], lower_count=counts[1], upper_count=counts[2],
        background=float(
            _f32(buf, base + offs[3] + 28, 1)[0]
        ),
    )


def _collect_constant_tiles(buf: bytes, md: dict):
    """Walk root -> upper -> lower and collect active constant *tiles*
    (regions with a value but no child; nanovdb.jl root/internal tile
    branches at :341-375). Returns a list of (origin_ijk, size, value)."""
    root_off = md["root_offset"]
    table_size = _u32(buf, root_off + 24)
    fills: list[tuple[tuple, int, float]] = []

    def key_to_origin(key: int):
        def se(v):  # 21 stored bits were (uint32 coord) >> 12
            u = (v << 12) & 0xFFFFFFFF
            return u - (1 << 32) if u >= (1 << 31) else u

        return (se((key >> 42) & 0x1FFFFF), se((key >> 21) & 0x1FFFFF),
                se(key & 0x1FFFFF))

    for i in range(table_size):
        toff = root_off + ROOT_HEADER + i * ROOT_TILE
        key = _u64(buf, toff)
        child = _i64(buf, toff + 8)
        state = _u32(buf, toff + 16)
        value = float(_f32(buf, toff + 20)[0])
        origin = key_to_origin(key)
        if child == 0:
            if state:
                fills.append((origin, 1 << UPPER_TOTAL, value))
            continue
        up = root_off + child
        u_vmask = np.unpackbits(
            np.frombuffer(buf, np.uint8, 4096, up + UPPER_VALUEMASK_OFF),
            bitorder="little")
        u_cmask = np.unpackbits(
            np.frombuffer(buf, np.uint8, 4096, up + UPPER_CHILDMASK_OFF),
            bitorder="little")
        u_table = np.frombuffer(buf, np.uint8, 32768 * 8, up + UPPER_TABLE_OFF)
        u_vals = u_table.view(np.float32)[::2]
        u_childs = u_table.view(np.int64)
        for n in np.nonzero(u_vmask | u_cmask)[0]:
            lx, ly, lz = (n >> 10) & 31, (n >> 5) & 31, n & 31
            o2 = (origin[0] + lx * 128, origin[1] + ly * 128, origin[2] + lz * 128)
            if not u_cmask[n]:
                fills.append((o2, 128, float(u_vals[n])))
                continue
            lo_off = up + int(u_childs[n])
            l_vmask = np.unpackbits(
                np.frombuffer(buf, np.uint8, 512, lo_off + LOWER_VALUEMASK_OFF),
                bitorder="little")
            l_cmask = np.unpackbits(
                np.frombuffer(buf, np.uint8, 512, lo_off + LOWER_CHILDMASK_OFF),
                bitorder="little")
            l_vals = np.frombuffer(
                buf, np.uint8, 4096 * 8, lo_off + LOWER_TABLE_OFF
            ).view(np.float32)[::2]
            for m in np.nonzero(l_vmask & ~l_cmask.astype(bool))[0]:
                mx, my, mz = (m >> 8) & 15, (m >> 4) & 15, m & 15
                o3 = (o2[0] + mx * 8, o2[1] + my * 8, o2[2] + mz * 8)
                fills.append((o3, 8, float(l_vals[m])))
    return fills


def to_dense(buf: bytes, md: dict | None = None):
    """Materialize the sparse tree into a dense (nz, ny, nx) grid: leaf
    voxels plus active constant root/internal tiles (clipped to the root
    index bbox, since a constant root tile nominally spans 4096^3).

    buf is the full file buffer (header parsed for metadata) or, when `md`
    is supplied, a bare node buffer from build_nanovdb. Returns
    (dense, index_min (3,), index_max (3,), metadata)."""
    if md is None:
        md = extract_metadata(buf)
    md = dict(md)
    md.setdefault("background", 0.0)
    n_leaf = md["leaf_count"]
    lo = md["leaf_offset"]

    origins = np.zeros((n_leaf, 3), np.int64)
    blocks = np.zeros((n_leaf, 512), np.float32)
    masks = np.zeros((n_leaf, 512), bool)
    for i in range(n_leaf):
        off = lo + i * LEAF_SIZE
        origins[i] = np.frombuffer(buf, np.int32, 3, off)
        mask_bits = np.frombuffer(buf, np.uint8, 64, off + LEAF_MASK_OFF)
        masks[i] = np.unpackbits(mask_bits, bitorder="little")
        blocks[i] = _f32(buf, off + LEAF_VALUES_OFF, 512)

    fills = _collect_constant_tiles(buf, md)
    if n_leaf == 0 and not fills:
        return np.zeros((1, 1, 1), np.float32), np.zeros(3, int), np.ones(3, int), md

    # root index bbox (inclusive max) bounds the constant-tile expansion
    bbox = np.frombuffer(buf, np.int32, 6, md["root_offset"])
    bb_lo, bb_hi = bbox[:3].astype(np.int64), bbox[3:].astype(np.int64) + 1
    has_bbox = np.all(bb_hi > bb_lo)

    pieces = []
    if n_leaf:
        pieces.append((origins.min(0), origins.max(0) + LEAF_DIM))
    for o3, size, _ in fills:
        f_lo = np.asarray(o3, np.int64)
        f_hi = f_lo + size
        if has_bbox:
            f_lo = np.maximum(f_lo, bb_lo)
            f_hi = np.minimum(f_hi, bb_hi)
        if np.all(f_hi > f_lo):
            pieces.append((f_lo, f_hi))
    imin = np.min([p[0] for p in pieces], axis=0)
    imax = np.max([p[1] for p in pieces], axis=0)

    ext = imax - imin
    dense = np.full((ext[2], ext[1], ext[0]), md["background"], np.float32)
    # coarse-to-fine: constant tiles first (largest first), leaves last
    for o3, size, value in sorted(fills, key=lambda f: -f[1]):
        f_lo = np.asarray(o3, np.int64)
        f_hi = f_lo + size
        if has_bbox:
            f_lo = np.maximum(f_lo, bb_lo)
            f_hi = np.minimum(f_hi, bb_hi)
        a = np.maximum(f_lo - imin, 0)
        b = np.minimum(f_hi - imin, ext)
        if np.all(b > a):
            dense[a[2]:b[2], a[1]:b[1], a[0]:b[0]] = value
    # leaf value order: offset = (x&7)<<6 | (y&7)<<3 | (z&7)  -> (x, y, z)
    vals = blocks.reshape(n_leaf, 8, 8, 8)           # [x][y][z]
    mk = masks.reshape(n_leaf, 8, 8, 8)
    vals = np.where(mk, vals, md["background"])
    for i in range(n_leaf):
        ox, oy, oz = origins[i] - imin
        dense[oz:oz + 8, oy:oy + 8, ox:ox + 8] = vals[i].transpose(2, 1, 0)
    return dense, imin, imax, md


def to_bricks(buf: bytes, md: dict | None = None):
    """Reindex the sparse tree into the device brick layout WITHOUT
    materializing the dense extent: active 8^3 leaves become bricks,
    active constant tiles become table ranges pointing at shared
    constant-filled bricks (one per distinct value).

    Returns (table (tbz,tby,tbx) int32, bricks (NB,512) f32, imin (3,),
    imax (3,), md) with index bounds 8-aligned."""
    if md is None:
        md = extract_metadata(buf)
    md = dict(md)
    md.setdefault("background", 0.0)
    bg = np.float32(md["background"])
    n_leaf = md["leaf_count"]
    lo = md["leaf_offset"]

    origins = np.zeros((n_leaf, 3), np.int64)
    blocks = np.zeros((n_leaf, 512), np.float32)
    for i in range(n_leaf):
        off = lo + i * LEAF_SIZE
        origins[i] = np.frombuffer(buf, np.int32, 3, off)
        mask = np.unpackbits(
            np.frombuffer(buf, np.uint8, 64, off + LEAF_MASK_OFF),
            bitorder="little").astype(bool)
        vals = _f32(buf, off + LEAF_VALUES_OFF, 512)
        blocks[i] = np.where(mask, vals, bg)

    fills = _collect_constant_tiles(buf, md)
    if n_leaf == 0 and not fills:
        return (np.full((1, 1, 1), -1, np.int32),
                np.zeros((0, 512), np.float32),
                np.zeros(3, np.int64), np.full(3, 8, np.int64), md)

    bbox = np.frombuffer(buf, np.int32, 6, md["root_offset"])
    bb_lo, bb_hi = bbox[:3].astype(np.int64), bbox[3:].astype(np.int64) + 1
    has_bbox = np.all(bb_hi > bb_lo)

    pieces = []
    if n_leaf:
        pieces.append((origins.min(0), origins.max(0) + LEAF_DIM))
    clipped_fills = []
    for o3, size, value in fills:
        f_lo = np.asarray(o3, np.int64)
        f_hi = f_lo + size
        if has_bbox:
            f_lo = np.maximum(f_lo, bb_lo)
            f_hi = np.minimum(f_hi, bb_hi)
        if np.all(f_hi > f_lo):
            pieces.append((f_lo, f_hi))
            clipped_fills.append((f_lo, f_hi, value))
    imin = np.min([p[0] for p in pieces], axis=0)
    imax = np.max([p[1] for p in pieces], axis=0)
    # 8-align so fills and leaves land on whole table cells
    imin = (imin // 8) * 8
    imax = ((imax + 7) // 8) * 8

    tb = ((imax - imin) // 8).astype(np.int64)
    table = np.full((tb[2], tb[1], tb[0]), -1, np.int32)
    brick_list = []

    # constant tiles first, coarse to fine, each value one shared brick
    const_brick: dict[float, int] = {}
    for f_lo, f_hi, value in sorted(clipped_fills, key=lambda f: -(f[1] - f[0]).max()):
        if value not in const_brick:
            const_brick[value] = len(brick_list)
            brick_list.append(np.full(512, value, np.float32))
        a = (f_lo - imin) // 8
        b = (f_hi - imin + 7) // 8
        table[a[2]:b[2], a[1]:b[1], a[0]:b[0]] = const_brick[value]

    # leaves override: voxel order ((z&7)*8+(y&7))*8+(x&7); the file stores
    # (x<<6|y<<3|z), so transpose
    for i in range(n_leaf):
        blk = blocks[i].reshape(8, 8, 8)          # [x][y][z]
        brick_list.append(np.ascontiguousarray(
            blk.transpose(2, 1, 0).reshape(512)))  # -> [z][y][x]
        c = (origins[i] - imin) // 8
        table[c[2], c[1], c[0]] = len(brick_list) - 1

    bricks = (np.stack(brick_list) if brick_list
              else np.zeros((0, 512), np.float32))
    return table, bricks, imin, imax, md


def load_nanovdb_sparse(path: str):
    """Read a NanoVDB file into the sparse brick layout -> (table, bricks,
    world_lo, world_hi, background)."""
    with open(path, "rb") as f:
        buf = zlib.decompress(f.read())
    md = extract_metadata(buf)
    table, bricks, imin, imax, md = to_bricks(buf, md)
    wmin = np.asarray(md["world_min"], np.float64)
    wmax = np.asarray(md["world_max"], np.float64)
    inv = np.asarray(md["inv_mat"], np.float64)
    voxel = 1.0 / np.diag(inv)
    # the brick table spans the 8-aligned index bbox, which may exceed the
    # header's world bbox: derive world bounds from the index box + map
    wlo = np.asarray(md["vec"], np.float64) + imin * voxel
    whi = np.asarray(md["vec"], np.float64) + imax * voxel
    if not np.all(np.isfinite(wlo)):
        wlo, whi = wmin, wmax
    return (table, bricks, wlo.astype(np.float32), whi.astype(np.float32),
            float(md["background"]))


def build_nanovdb(dense: np.ndarray, origin=(0.0, 0.0, 0.0), extent=(1.0, 1.0, 1.0)):
    """Build the NanoVDB node buffer from a dense (nz, ny, nx) grid:
    only non-empty 8^3 leaves are stored (build_nanovdb_from_dense,
    nanovdb.jl:602-860). Returns (buffer bytes, metadata dict)."""
    d = np.asarray(dense, np.float32)
    nz, ny, nx = d.shape
    origin = np.asarray(origin, np.float64)
    extent = np.asarray(extent, np.float64)

    # pad to multiples of 8 and find non-empty leaves
    pz, py, px = [(-s) % 8 for s in (nz, ny, nx)]
    dp = np.pad(d, [(0, pz), (0, py), (0, px)])
    lz, ly, lx = dp.shape[0] // 8, dp.shape[1] // 8, dp.shape[2] // 8
    blocks = dp.reshape(lz, 8, ly, 8, lx, 8).transpose(0, 2, 4, 1, 3, 5)
    nonempty = np.abs(blocks).max(axis=(3, 4, 5)) > 0.0
    leaf_ids = np.argwhere(nonempty)  # (n_leaf, 3) as (iz, iy, ix)
    n_leaf = len(leaf_ids)

    leaf_buf = bytearray(n_leaf * LEAF_SIZE)
    # parent bookkeeping
    lowers: dict[tuple, dict] = {}
    uppers: dict[tuple, dict] = {}
    for li, (iz, iy, ix) in enumerate(leaf_ids):
        off = li * LEAF_SIZE
        ox, oy, oz = ix * 8, iy * 8, iz * 8
        leaf_buf[off:off + 12] = np.asarray([ox, oy, oz], np.int32).tobytes()
        leaf_buf[off + LEAF_MASK_OFF:off + LEAF_MASK_OFF + 64] = b"\xff" * 64
        blk = blocks[iz, iy, ix]            # [z][y][x]
        vals = blk.transpose(2, 1, 0).reshape(-1)  # -> [x][y][z] order
        leaf_buf[off + LEAF_VALUES_OFF:off + LEAF_VALUES_OFF + 2048] = (
            vals.astype(np.float32).tobytes()
        )
        lk = (ox >> 7, oy >> 7, oz >> 7)    # lower-node origin / 128
        n_low = (
            (((ox >> 3) & 15) << 8) | (((oy >> 3) & 15) << 4) | ((oz >> 3) & 15)
        )
        lowers.setdefault(lk, {})[n_low] = li

    lower_keys = sorted(lowers)
    lower_buf = bytearray(len(lower_keys) * LOWER_NODE_SIZE)
    for wi, lk in enumerate(lower_keys):
        off = wi * LOWER_NODE_SIZE
        table = np.zeros(4096, np.int64)
        cmask = np.zeros(512, np.uint8)
        for n_low, li in lowers[lk].items():
            # child offset relative to this lower node's start
            lower_abs = n_leaf * LEAF_SIZE + wi * LOWER_NODE_SIZE
            table[n_low] = li * LEAF_SIZE - lower_abs
            cmask[n_low >> 3] |= 1 << (n_low & 7)
        lower_buf[off + LOWER_CHILDMASK_OFF:off + LOWER_CHILDMASK_OFF + 512] = bytes(cmask)
        lower_buf[off + LOWER_TABLE_OFF:off + LOWER_TABLE_OFF + 4096 * 8] = table.tobytes()
        uk = (lk[0] >> 5, lk[1] >> 5, lk[2] >> 5)
        n_up = (
            ((lk[0] & 31) << 10) | ((lk[1] & 31) << 5) | (lk[2] & 31)
        )
        uppers.setdefault(uk, {})[n_up] = wi

    upper_keys = sorted(uppers)
    upper_base = n_leaf * LEAF_SIZE + len(lower_keys) * LOWER_NODE_SIZE
    upper_buf = bytearray(len(upper_keys) * UPPER_NODE_SIZE)
    for ui, uk in enumerate(upper_keys):
        off = ui * UPPER_NODE_SIZE
        table = np.zeros(32768, np.int64)
        cmask = np.zeros(4096, np.uint8)
        for n_up, wi in uppers[uk].items():
            upper_abs = upper_base + ui * UPPER_NODE_SIZE
            lower_abs = n_leaf * LEAF_SIZE + wi * LOWER_NODE_SIZE
            table[n_up] = lower_abs - upper_abs
            cmask[n_up >> 3] |= 1 << (n_up & 7)
        upper_buf[off + UPPER_CHILDMASK_OFF:off + UPPER_CHILDMASK_OFF + 4096] = bytes(cmask)
        upper_buf[off + UPPER_TABLE_OFF:off + UPPER_TABLE_OFF + 32768 * 8] = table.tobytes()

    root_base = upper_base + len(upper_keys) * UPPER_NODE_SIZE
    root_buf = bytearray(ROOT_HEADER + len(upper_keys) * ROOT_TILE)
    root_buf[24:28] = np.uint32(len(upper_keys)).tobytes()
    root_buf[28:32] = np.float32(0.0).tobytes()  # background
    for ui, uk in enumerate(upper_keys):
        t = ROOT_HEADER + ui * ROOT_TILE
        key = (
            (np.uint64(uk[2] & 0x1FFFFF))
            | (np.uint64(uk[1] & 0x1FFFFF) << np.uint64(21))
            | (np.uint64(uk[0] & 0x1FFFFF) << np.uint64(42))
        )
        root_buf[t:t + 8] = np.uint64(key).tobytes()
        upper_abs = upper_base + ui * UPPER_NODE_SIZE
        root_buf[t + 8:t + 16] = np.int64(upper_abs - root_base).tobytes()

    buf = bytes(leaf_buf) + bytes(lower_buf) + bytes(upper_buf) + bytes(root_buf)
    voxel = extent / np.array([nx, ny, nz], np.float64)
    inv_mat = np.diag(1.0 / voxel).astype(np.float32)
    md = dict(
        leaf_offset=0, lower_offset=n_leaf * LEAF_SIZE,
        upper_offset=upper_base, root_offset=root_base,
        leaf_count=n_leaf, lower_count=len(lower_keys),
        upper_count=len(upper_keys),
        inv_mat=inv_mat, vec=origin.astype(np.float32),
        world_min=origin, world_max=origin + extent,
    )
    return buf, md


def save_nanovdb(path: str, dense: np.ndarray, origin=(0, 0, 0), extent=(1, 1, 1)):
    """Write a zlib-compressed NanoVDB-layout file (save_nanovdb,
    nanovdb.jl:868-1108)."""
    node_buf, md = build_nanovdb(dense, origin, extent)
    header = bytearray(GRIDDATA_SIZE + TREEDATA_SIZE)
    inv = np.asarray(md["inv_mat"], np.float64)
    mat = np.linalg.inv(inv)
    header[MAP_OFFSET:MAP_OFFSET + 36] = mat.astype(np.float32).tobytes()
    header[MAP_INVMAT:MAP_INVMAT + 36] = inv.astype(np.float32).tobytes()
    header[MAP_VEC:MAP_VEC + 12] = np.asarray(md["vec"], np.float32).tobytes()
    header[WORLDBBOX:WORLDBBOX + 48] = np.concatenate(
        [np.asarray(md["world_min"], np.float64), np.asarray(md["world_max"], np.float64)]
    ).tobytes()
    # node offsets are relative to TreeData start = byte 672 of the file;
    # nodes begin at 736, so relative = node_offset_in_buf + 64
    offs = np.asarray(
        [md["leaf_offset"] + 64, md["lower_offset"] + 64,
         md["upper_offset"] + 64, md["root_offset"] + 64], np.uint64,
    )
    header[TREE_NODE_OFFSETS:TREE_NODE_OFFSETS + 32] = offs.tobytes()
    counts = np.asarray(
        [md["leaf_count"], md["lower_count"], md["upper_count"]], np.uint32
    )
    header[TREE_NODE_COUNTS:TREE_NODE_COUNTS + 12] = counts.tobytes()
    with open(path, "wb") as f:
        f.write(zlib.compress(bytes(header) + node_buf, 6))


def load_nanovdb(path: str):
    """Read a zlib-compressed NanoVDB file -> (dense (nz,ny,nx), world_lo,
    world_hi).

    World bounds are derived from the CROPPED index box through the grid
    map — to_dense drops empty border leaves, so the header's world bbox
    (which spans the full original grid) would stretch the cropped array
    over the wrong region."""
    with open(path, "rb") as f:
        buf = zlib.decompress(f.read())
    dense, imin, imax, md = to_dense(buf)
    inv = np.asarray(md["inv_mat"], np.float64)
    voxel = 1.0 / np.diag(inv)
    wmin = np.asarray(md["vec"], np.float64) + imin * voxel
    wmax = np.asarray(md["vec"], np.float64) + imax * voxel
    if not np.all(np.isfinite(wmin)):
        wmin = np.asarray(md["world_min"], np.float64)
        wmax = np.asarray(md["world_max"], np.float64)
    return dense, wmin.astype(np.float32), wmax.astype(np.float32)


# dense extents past this voxel count auto-select the sparse brick path
SPARSE_AUTO_VOXELS = 64 * 1024 * 1024


def nanovdb_medium(path: str, sigma_a=(0.0, 0.0, 0.0), sigma_s=(1.0, 1.0, 1.0),
                   g: float = 0.0, scale: float = 1.0, sparse: bool | None = None):
    """NanoVDBMedium constructor (nanovdb.jl:1320+).

    sparse=True (or auto when the dense extent exceeds SPARSE_AUTO_VOXELS):
    the grid stays in the brick-paged sparse layout on device — a
    BOMEX-class cloud with a large, mostly-empty index bbox never
    materializes its dense extent. sparse=False: densify to a GridMedium."""
    from .types import BrickGridMedium, GridMedium

    if sparse is None:
        with open(path, "rb") as f:
            buf = zlib.decompress(f.read())
        md = extract_metadata(buf)
        bbox = np.frombuffer(buf, np.int32, 6, md["root_offset"])
        ext = np.maximum(bbox[3:].astype(np.int64) + 1 - bbox[:3], 1)
        sparse = bool(np.prod(ext) > SPARSE_AUTO_VOXELS)

    if sparse:
        table, bricks, wlo, whi, bg = load_nanovdb_sparse(path)
        return BrickGridMedium(
            table=table, bricks=bricks, bounds_lo=tuple(wlo),
            bounds_hi=tuple(whi), background=bg,
            sigma_a=sigma_a, sigma_s=sigma_s, g=g, scale=scale,
        )
    dense, wlo, whi = load_nanovdb(path)
    return GridMedium(
        density=dense, bounds_lo=tuple(wlo), bounds_hi=tuple(whi),
        sigma_a=sigma_a, sigma_s=sigma_s, g=g, scale=scale,
    )
