"""Versioned, memory-mappable bucket-tile cache, and the feeds that
stream it to the device.

Cold-start ingest (text parsing, padding, layout packing) is paid ONCE:
`build_cache` packs a dataset into bucket tiles — examples grouped into
buckets of B, each bucket stored as one contiguous (d_pad x B) tile
(dense) or (B x nnz) idx/val tile pair (sparse), bucket-major,
pod-sharded on the leading axis:

    X.bin    (pods, nb_pod, d_pad, B)  float32     [dense]
    idx.bin  (pods, nb_pod, B, nnz)    int32       [sparse]
    val.bin  (pods, nb_pod, B, nnz)    float32     [sparse]
    y.bin    (pods, nb_pod, B)         float32
    tilecrc.bin                        crc32 of every bucket tile
    meta.json  — magic/version, shapes, true example count, crc32s

The files are byte-identical to the reference package's
(`repro.data.cache`, layout version 3) for the same arrays, so a cache
built by either package opens and trains in the other.  The writer is a
pure function of the input arrays (fixed dtypes, C order, sorted-key
JSON, no timestamps), and meta.json is written last and atomically: it
is the validity marker, so a build killed part-way is never opened.

Epoch start is then an mmap + gather: `TileCache.gather_buckets` fancy-
indexes the memmap with global bucket ids, touching only the tiles a
chunk visits, and `TileFeed` copies the result to the device — the
`ChunkFeed` that `repro_torch.core.engine`'s streamed loop consumes.
Bucket b lives at ``tiles[b // nb_pod, b % nb_pod]``, matching
`PartitionPlan`'s static pod ranges.  On a CUDA device a feed gathers
into pinned host buffers and copies them on with
``non_blocking=True`` on the calling thread's current stream
(`PinnedStaging`).

Padding: n is padded up to a multiple of ``pods * bucket`` (or the
caller's stricter ``pad_multiple``) with x=0 / y=+1 examples, which
never move the shared vector v; ``n_examples`` records the true count.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import threading
import zlib

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "CACHE_MAGIC", "CACHE_VERSION", "CacheMeta", "TileCache",
    "TileCorruptionError", "PinnedStaging",
    "ArrayFeed", "TileFeed", "build_cache", "compact_slice_rows",
    "open_cache", "pad_examples",
]

CACHE_MAGIC = "repro-tile-cache"
# The reference's layout versions: v2 dedupes synthetic sparse rows and
# draws criteo sub rows 40 wide; v3 adds the per-tile crc32 sidecar
# (tilecrc.bin) and writes meta.json last and atomically.  The same
# value as the reference's, so caches cross between the packages.
CACHE_VERSION = 3

_SUBLANE = 8          # dense tiles pad d to a multiple of 8 (the layout)

_TILECRC_FILE = "tilecrc.bin"


class TileCorruptionError(ValueError):
    """A cache tile's bytes no longer match their recorded crc32.

    ``path`` is the corrupt ``.bin`` file, ``array`` its logical name,
    ``tile`` the GLOBAL bucket id of the first bad tile (None when only
    the whole-array checksum is available), ``offset`` the byte offset
    of that tile inside the file.  Raised by `open_cache(verify=True)`,
    `TileCache.verify_tiles` and `TileFeed(verify=True)`: the bytes will
    not get better, so quarantine the cache and rebuild it from source.
    """

    def __init__(self, path, array: str, tile: int | None = None,
                 offset: int | None = None):
        self.path = pathlib.Path(path)
        self.array = array
        self.tile = tile
        self.offset = offset
        loc = (f" (tile {tile} at byte offset {offset})"
               if tile is not None else "")
        super().__init__(
            f"{self.path}: crc32 mismatch for array {array!r}{loc} — "
            f"cache is corrupt; quarantine and rebuild from source")


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def compact_slice_rows(idx: np.ndarray, val: np.ndarray, lo: int,
                       hi: int, *, nnz_multiple: int = 8,
                       positions: bool = False,
                       width: int | None = None):
    """Compact padded-CSR rows to the entries in feature slice [lo, hi).

    The host half of the slice-compacted streamed feed, shared by
    `TileCache.slice_gather` and the mesh feed's array-backed path; a
    copy of the reference's, byte for byte.  Entries are kept IN ROW
    ORDER (a stable left-compaction: the kernels' bitwise contract
    depends on the within-row summation order) and right-padded to a
    common width ``w``: the max kept count ceiled to ``nnz_multiple``,
    or exactly ``width`` when given (so streamed chunks share one
    shape; raises if a row overflows it).

    Two modes:

      * ``positions=False`` (default): keep nonzeros with
        ``lo <= idx < hi`` and REBASE ids to slice-local coordinates
        (idx - lo).  Returns ``(idx_loc, val_loc)``.
      * ``positions=True``: the transfer format for exact row
        reassembly on the device.  Keeps every in-slice entry that is
        not (idx=0, val=0) padding, explicit zero VALUES included
        (`formats.zero_duplicates` products), which a reassembled row
        must reproduce, and returns ``(idx, val, pos)`` with GLOBAL ids
        and each entry's original position in its row; pad slots carry
        ``pos = nnz``, which the reassembly drops, so a scatter into a
        zero base rebuilds the original row bitwise.

    All outputs are (*lead, w): idx/pos int32, val float32.
    """
    if not 0 <= lo < hi:
        raise ValueError(f"bad feature slice [{lo}, {hi})")
    in_slice = (idx >= lo) & (idx < hi)
    own = in_slice & (((val != 0) | (idx != 0)) if positions
                      else (val != 0))
    # stable left-compaction: sort each row by (not owned) so owned
    # entries keep their relative order
    order = np.argsort(~own, axis=-1, kind="stable")
    idx_s = np.take_along_axis(idx, order, axis=-1)
    val_s = np.take_along_axis(val, order, axis=-1)
    own_s = np.take_along_axis(own, order, axis=-1)
    need = max(int(own.sum(axis=-1).max(initial=0)), 1)
    if width is None:
        w = _ceil_to(need, nnz_multiple)
    else:
        w = int(width)
        if need > w:
            raise ValueError(
                f"width={w} too narrow: a row holds {need} entries "
                f"in slice [{lo}, {hi})")
    nnz = idx.shape[-1]
    val_c = np.where(own_s, val_s, 0.0).astype(np.float32)
    if positions:
        idx_c = np.where(own_s, idx_s, 0).astype(np.int32)
        pos = np.where(own_s, order, nnz).astype(np.int32)
        outs = [idx_c, val_c, pos]
        fills = [0, 0.0, nnz]     # pad slots keep the drop sentinel
    else:
        idx_c = np.where(own_s, idx_s - lo, 0).astype(np.int32)
        outs = [idx_c, val_c]
        fills = [0, 0.0]
    if w > nnz:                   # raw caches with unaligned nnz
        pad = [(0, 0)] * (idx_c.ndim - 1) + [(0, w - nnz)]
        outs = [np.pad(o, pad, constant_values=f)
                for o, f in zip(outs, fills)]
    return tuple(np.ascontiguousarray(o[..., :w]) for o in outs)


@dataclasses.dataclass(frozen=True)
class CacheMeta:
    """Everything needed to mmap the arrays back + provenance."""
    name: str
    kind: str                  # dense | sparse
    n: int                     # padded example count (what training sees)
    n_examples: int            # true example count before padding
    d: int
    d_pad: int                 # dense tile row count (d rounded up)
    bucket: int
    pods: int
    nnz: int                   # sparse only; 0 for dense
    objective: str
    version: int = CACHE_VERSION
    magic: str = CACHE_MAGIC

    @property
    def n_buckets(self) -> int:
        return self.n // self.bucket

    @property
    def nb_pod(self) -> int:
        return self.n_buckets // self.pods

    def array_specs(self) -> dict[str, tuple[tuple[int, ...], str]]:
        """name -> (shape, dtype) of every .bin file."""
        P, nbp, B = self.pods, self.nb_pod, self.bucket
        if self.kind == "dense":
            arrs = {"X": ((P, nbp, self.d_pad, B), "float32")}
        else:
            arrs = {"idx": ((P, nbp, B, self.nnz), "int32"),
                    "val": ((P, nbp, B, self.nnz), "float32")}
        arrs["y"] = ((P, nbp, B), "float32")
        return arrs


def pad_examples(y: np.ndarray, multiple: int, *,
                 X: np.ndarray | None = None,
                 idx: np.ndarray | None = None,
                 val: np.ndarray | None = None):
    """Pad n up to `multiple` with inert examples (x=0, y=+1)."""
    n = y.shape[0]
    n_pad = _ceil_to(max(n, 1), multiple)
    if n_pad == n:
        return y, X, idx, val
    extra = n_pad - n
    y = np.concatenate([y, np.ones(extra, dtype=y.dtype)])
    if X is not None:
        X = np.concatenate(
            [X, np.zeros((X.shape[0], extra), dtype=X.dtype)], axis=1)
    if idx is not None:
        idx = np.concatenate(
            [idx, np.zeros((extra, idx.shape[1]), dtype=idx.dtype)])
        val = np.concatenate(
            [val, np.zeros((extra, val.shape[1]), dtype=val.dtype)])
    return y, X, idx, val


def build_cache(path, name: str, *, y, X=None, idx=None, val=None,
                d: int | None = None, kind: str | None = None,
                bucket: int = 16, pods: int = 1,
                pad_multiple: int | None = None,
                nnz_multiple: int | None = None,
                objective: str = "logistic") -> "TileCache":
    """Pack arrays into bucket tiles and write a cache directory.

    Dense input: ``X (d, n)``; sparse input: ``idx/val (n, nnz)`` plus
    ``d``.  ``pad_multiple`` defaults to ``pods * bucket`` — callers
    that know the training topology pass the stricter
    pods*lanes*lanes*chunks*bucket so every partition mode divides.
    ``nnz_multiple`` (sparse only) zero-pads the row width with inert
    idx=0/val=0 columns up to that multiple; padding columns never
    change margins or updates.
    """
    path = pathlib.Path(path)
    if kind is None:
        kind = "dense" if X is not None else "sparse"
    y = np.ascontiguousarray(np.asarray(y, np.float32))
    n_examples = y.shape[0]
    mult = pad_multiple or (pods * bucket)
    mult = _ceil_to(mult, pods * bucket)

    if kind == "dense":
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        d = X.shape[0]
        y, X, _, _ = pad_examples(y, mult, X=X)
        n = y.shape[0]
        d_pad = _ceil_to(d, _SUBLANE)
        nb = n // bucket
        Xp = np.zeros((d_pad, n), dtype=np.float32)
        Xp[:d] = X
        # (d_pad, nb, B) -> bucket-major tiles (pods, nb_pod, d_pad, B)
        tiles = np.transpose(Xp.reshape(d_pad, nb, bucket), (1, 0, 2))
        arrays = {"X": np.ascontiguousarray(tiles).reshape(
            pods, nb // pods, d_pad, bucket)}
        nnz = 0
    else:
        idx = np.ascontiguousarray(np.asarray(idx, np.int32))
        val = np.ascontiguousarray(np.asarray(val, np.float32))
        if d is None:
            raise ValueError("sparse build_cache requires d")
        if nnz_multiple:
            pad_w = _ceil_to(max(idx.shape[1], 1), nnz_multiple) \
                - idx.shape[1]
            if pad_w:
                idx = np.pad(idx, ((0, 0), (0, pad_w)))
                val = np.pad(val, ((0, 0), (0, pad_w)))
        y, _, idx, val = pad_examples(y, mult, idx=idx, val=val)
        n = y.shape[0]
        nnz = idx.shape[1]
        nb = n // bucket
        arrays = {
            "idx": idx.reshape(pods, nb // pods, bucket, nnz),
            "val": val.reshape(pods, nb // pods, bucket, nnz)}
        d_pad = d
    arrays["y"] = y.reshape(pods, nb // pods, bucket)

    meta = CacheMeta(name=name, kind=kind, n=n, n_examples=n_examples,
                     d=d, d_pad=d_pad, bucket=bucket, pods=pods,
                     nnz=nnz, objective=objective)
    path.mkdir(parents=True, exist_ok=True)
    crcs = {}
    tile_crcs = []
    for aname, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        crcs[aname] = zlib.crc32(arr.tobytes())
        tile_crcs.append(_tile_crcs(arr, meta.n_buckets))
        arr.tofile(path / f"{aname}.bin")
    # Sidecar next (arrays in array_specs order), meta.json LAST and
    # ATOMICALLY: a build killed at any earlier point leaves a directory
    # open_cache rejects and registry.materialize rebuilds.
    np.concatenate(tile_crcs).tofile(path / _TILECRC_FILE)
    doc = dict(dataclasses.asdict(meta), crc32=crcs)
    tmp = path / ".meta.json.tmp"
    tmp.write_text(json.dumps(doc, sort_keys=True, indent=1) + "\n")
    os.replace(tmp, path / "meta.json")
    return open_cache(path)


def _tile_crcs(arr: np.ndarray, n_buckets: int) -> np.ndarray:
    """crc32 of each bucket tile's bytes, as little-endian uint32."""
    flat = np.ascontiguousarray(arr).reshape(n_buckets, -1)
    return np.array([zlib.crc32(row.tobytes()) for row in flat],
                    dtype="<u4")


def _load_tilecrc(path: pathlib.Path,
                  meta: CacheMeta) -> dict[str, np.ndarray] | None:
    """Read the per-tile crc sidecar back into {array: (n_buckets,)}."""
    f = path / _TILECRC_FILE
    specs = meta.array_specs()
    want = meta.n_buckets * len(specs)
    if not f.exists() or f.stat().st_size != want * 4:
        return None
    raw = np.fromfile(f, dtype="<u4", count=want)
    return {aname: raw[i * meta.n_buckets:(i + 1) * meta.n_buckets]
            for i, aname in enumerate(specs)}


def open_cache(path, *, verify: bool = False) -> "TileCache":
    """mmap an existing cache directory; validates magic/version/sizes."""
    path = pathlib.Path(path)
    doc = json.loads((path / "meta.json").read_text())
    if doc.get("magic") != CACHE_MAGIC:
        raise ValueError(f"{path}: not a {CACHE_MAGIC} directory")
    if doc.get("version") != CACHE_VERSION:
        raise ValueError(f"{path}: cache version {doc.get('version')} != "
                         f"supported {CACHE_VERSION}; rebuild the cache")
    crcs = doc.pop("crc32", {})
    meta = CacheMeta(**{f.name: doc[f.name]
                        for f in dataclasses.fields(CacheMeta)})
    tilecrc = _load_tilecrc(path, meta)
    arrays = {}
    for aname, (shape, dtype) in meta.array_specs().items():
        f = path / f"{aname}.bin"
        want = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if f.stat().st_size != want:
            raise ValueError(
                f"{f}: {f.stat().st_size} bytes on disk, expected {want} "
                f"for shape {shape} — cache is truncated or corrupt")
        arrays[aname] = np.memmap(f, dtype=dtype, mode="r", shape=shape)
    cache = TileCache(meta=meta, path=path, arrays=arrays, tilecrc=tilecrc)
    if verify:
        if tilecrc is not None:
            cache.verify_tiles()
        else:
            for aname, mm in arrays.items():
                if zlib.crc32(mm.tobytes()) != crcs.get(aname):
                    raise TileCorruptionError(path / f"{aname}.bin", aname)
    return cache


@dataclasses.dataclass
class TileCache:
    """An opened cache: meta + read-only memmaps of the tile arrays."""
    meta: CacheMeta
    path: pathlib.Path
    arrays: dict[str, np.memmap]
    tilecrc: dict[str, np.ndarray] | None = None

    def _flat(self, name: str) -> np.ndarray:
        """(pods, nb_pod, ...) view -> (n_buckets, ...) for id math."""
        a = self.arrays[name]
        return a.reshape((self.meta.n_buckets,) + a.shape[2:])

    def verify_tiles(self, bids: np.ndarray | None = None) -> None:
        """Check the crc32 of bucket tiles against the sidecar.

        ``bids`` is a set of GLOBAL bucket ids (any shape); None means
        every tile.  Raises `TileCorruptionError` pointing at the first
        bad tile.  Cost scales with the bytes actually checked, so a
        streamed feed can verify only the tiles a chunk touches.
        """
        if self.tilecrc is None:
            raise ValueError(
                f"{self.path}: no {_TILECRC_FILE} sidecar — rebuild the "
                f"cache to enable per-tile verification")
        ids = (np.arange(self.meta.n_buckets) if bids is None
               else np.unique(np.asarray(bids).reshape(-1)))
        for aname in self.meta.array_specs():
            flat = self._flat(aname)
            tile_nbytes = int(np.prod(flat.shape[1:])) * flat.dtype.itemsize
            want = self.tilecrc[aname]
            for b in ids:
                b = int(b)
                if zlib.crc32(np.ascontiguousarray(
                        flat[b]).tobytes()) != int(want[b]):
                    raise TileCorruptionError(
                        self.path / f"{aname}.bin", aname, tile=b,
                        offset=b * tile_nbytes)

    # -- bulk load (the in-memory path) ----------------------------------
    def load_arrays(self):
        """Unpack tiles to flat example order, fully in memory.

        Dense: (X (d, n), y).  Sparse: ((idx, val), y).  Exactly the
        arrays `build_cache` packed (padding included), so in-memory
        and streamed training see identical data.
        """
        m = self.meta
        y = np.ascontiguousarray(self._flat("y")).reshape(m.n)
        if m.kind == "dense":
            t = np.ascontiguousarray(self._flat("X"))  # (nb, d_pad, B)
            X = np.transpose(t, (1, 0, 2)).reshape(m.d_pad, m.n)[:m.d]
            return np.ascontiguousarray(X), y
        idx = np.ascontiguousarray(self._flat("idx")).reshape(m.n, m.nnz)
        val = np.ascontiguousarray(self._flat("val")).reshape(m.n, m.nnz)
        return (idx, val), y

    # -- tile gather (the out-of-core path) ------------------------------
    def chunk_specs(self, lead: tuple[int, ...], nb: int, rows=None
                    ) -> dict[str, tuple[tuple[int, ...], np.dtype]]:
        """name -> (shape, dtype) of what `gather_buckets` returns for
        bucket ids of shape (*lead, nb), in its order (data, then y);
        ``rows`` (lo, hi) keeps dense features lo .. hi-1."""
        m = self.meta
        lo, hi = rows if rows is not None else (0, m.d)
        rows = lead + (nb * m.bucket,)
        if m.kind == "dense":
            specs = {"X": (lead + (hi - lo, nb * m.bucket), np.float32)}
        else:
            specs = {"idx": (rows + (m.nnz,), np.int32),
                     "val": (rows + (m.nnz,), np.float32)}
        specs["y"] = (rows, np.float32)
        return specs

    def gather_buckets(self, bids: np.ndarray, out=None, rows=None):
        """Gather whole bucket tiles by GLOBAL bucket id.

        bids (*lead, nb) int -> dense  (data (*lead, d, nb*B), y ...)
                              -> sparse ((idx, val) (*lead, nb*B, nnz), y)
        ``rows`` (lo, hi) keeps only dense features lo .. hi-1 (a tensor-
        parallel lane's rows).
        Only the touched tiles are read from the mmap, each array by one
        `np.take` into ``out``: a dict of arrays shaped as `chunk_specs`
        says, new ones when it is None.  A feed passes its pinned
        staging buffers, so sparse tiles and labels go from the mmap
        straight into page-locked memory; dense tiles cross one scratch
        array, and the swap of tile axes and the crop of d_pad to d are
        one copy into ``out``.
        """
        m = self.meta
        bids = np.asarray(bids)
        lead, nb = bids.shape[:-1], bids.shape[-1]
        if out is None:
            out = {k: np.empty(s, dt) for k, (s, dt) in
                   self.chunk_specs(lead, nb, rows).items()}
        if bids.size and (bids.min() < 0 or bids.max() >= m.n_buckets):
            raise IndexError(f"bucket ids outside [0, {m.n_buckets})")
        B = m.bucket
        # mode="clip" lets take write into `out` unbuffered; the ids
        # were range-checked above
        np.take(self._flat("y"), bids, axis=0, mode="clip",
                out=out["y"].reshape(lead + (nb, B)))
        if m.kind == "dense":
            lo, hi = rows if rows is not None else (0, m.d)
            t = np.take(self._flat("X"), bids, axis=0, mode="clip")
            np.copyto(out["X"].reshape(lead + (hi - lo, nb, B)),
                      np.swapaxes(t, -3, -2)[..., lo:hi, :, :])
            return out["X"], out["y"]
        for aname in ("idx", "val"):
            np.take(self._flat(aname), bids, axis=0, mode="clip",
                    out=out[aname].reshape(lead + (nb, B, m.nnz)))
        return (out["idx"], out["val"]), out["y"]

    def slice_gather(self, bids: np.ndarray, lo: int, hi: int, *,
                     nnz_multiple: int = 8, positions: bool = False,
                     width: int | None = None, gathered=None):
        """Gather sparse bucket tiles compacted to a feature slice [lo, hi).

        A model lane that owns rows [lo, hi) of the shared vector needs
        only the nonzeros in its slice.  The compaction is
        `compact_slice_rows` (``positions``/``width`` pass through): by
        default slice-LOCAL ``((idx_loc, val_loc), y)``; with
        ``positions=True`` the mesh transfer format ``((idx, val, pos),
        y)``, global ids and each entry's position in its row, which
        `engine.MeshChunkFeed` ships per model lane and the mesh step
        scatters back into exact rows.  ``gathered`` is a prior
        ``gather_buckets(bids)`` result, so a feed compacting one chunk
        for M lanes reads the mmap once.
        """
        if self.meta.kind != "sparse":
            raise ValueError("slice_gather is sparse-only")
        (idx, val), y = (gathered if gathered is not None
                         else self.gather_buckets(bids))
        out = compact_slice_rows(idx, val, lo, hi,
                                 nnz_multiple=nnz_multiple,
                                 positions=positions, width=width)
        return out, y

    def feed(self, *, verify: bool = False, device="cuda") -> "TileFeed":
        return TileFeed(self, verify=verify, device=device)


# ---------------------------------------------------------------------------
# Host-to-device staging and the ChunkFeeds (the protocol lives in
# core.engine)
# ---------------------------------------------------------------------------


class _Slot:
    """One set of pinned host buffers and the event of its last copy."""

    def __init__(self):
        self.host: dict[str, torch.Tensor] = {}
        self.event = None

    def arrays(self, specs) -> dict[str, np.ndarray]:
        """numpy views of this slot's pinned buffers, (re)allocated when
        a shape or dtype changes."""
        out = {}
        for name, (shape, dtype) in specs.items():
            buf = self.host.get(name)
            want = torch.from_numpy(np.empty(0, dtype)).dtype
            if buf is None or tuple(buf.shape) != tuple(shape) \
                    or buf.dtype != want:
                buf = torch.empty(shape, dtype=want, pin_memory=True)
                self.host[name] = buf
            out[name] = buf.numpy()
        return out


class PinnedStaging:
    """Host-to-device copies of a feed's chunks.

    On a CUDA device each chunk is written into one of `SLOTS` sets of
    page-locked host buffers (two: the streamed loop fetches one chunk
    ahead), copied with ``non_blocking=True`` on the
    CALLING thread's current stream (the streamed loop's side stream,
    in its prefetch thread), and an event recorded after the copies
    guards the set: a slot is rewritten only once its last copy's event
    has completed.  The returned device tensors are ready on that stream
    only; a consumer on another stream waits on it (the streamed loop
    does).  On the CPU the host arrays are returned as tensors.
    """

    SLOTS = 2

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._slots = [_Slot() for _ in range(self.SLOTS)]
        self._next = 0
        self._lock = threading.Lock()

    def put(self, specs, fill) -> dict[str, torch.Tensor]:
        """`fill(bufs)` writes each array named in `specs` ({name:
        (shape, dtype)}) into ``bufs[name]``; -> {name: device tensor}."""
        if self.device.type != "cuda":
            bufs = {k: np.empty(s, dt) for k, (s, dt) in specs.items()}
            fill(bufs)
            return {k: torch.from_numpy(b) for k, b in bufs.items()}
        with self._lock:
            slot = self._slots[self._next]
            self._next = (self._next + 1) % len(self._slots)
            if slot.event is not None:
                slot.event.synchronize()
            fill(slot.arrays(specs))
            out = {k: slot.host[k].to(self.device, non_blocking=True)
                   for k in specs}
            slot.event = torch.cuda.Event()
            slot.event.record()
        return out


class TileFeed:
    """`ChunkFeed` over a `TileCache`: mmap gather into pinned buffers,
    then a copy to ``device`` (default the card; a missing GPU raises).

    ``verify=True`` crc-checks exactly the tiles each fetch touches
    against the per-tile sidecar before handing them to the engine
    (raising `TileCorruptionError`).  Default off: the fault-free hot
    loop pays no checksum cost.
    """

    def __init__(self, cache: TileCache, *, verify: bool = False,
                 device="cuda"):
        self.cache = cache
        self.verify = verify
        self.staging = PinnedStaging(device)
        self.device = self.staging.device
        m = cache.meta
        self.n, self.d, self.bucket = m.n, m.d, m.bucket
        self.sparse = m.kind == "sparse"

    def fetch(self, bids: np.ndarray):
        bids = np.asarray(bids)
        if self.verify:
            self.cache.verify_tiles(bids)
        specs = self.cache.chunk_specs(bids.shape[:-1], bids.shape[-1])
        t = self.staging.put(
            specs, lambda bufs: self.cache.gather_buckets(bids, out=bufs))
        if self.sparse:
            return (t["idx"], t["val"]), t["y"]
        return t["X"], t["y"]


class ArrayFeed:
    """`ChunkFeed` over resident host arrays — the in-memory twin of
    `TileFeed`, which separates cache exactness from the streamed-loop
    contract; `Session(arrays, streamed=True)` trains through it."""

    def __init__(self, y, *, X=None, idx=None, val=None,
                 d: int | None = None, bucket: int = 16, device="cuda"):
        self.y = np.asarray(y, np.float32)
        self.n, self.bucket = self.y.shape[0], bucket
        self.sparse = X is None
        if self.sparse:
            self.idx = np.asarray(idx, np.int32)
            self.val = np.asarray(val, np.float32)
            self.d = int(d)
        else:
            self.X = np.asarray(X, np.float32)
            self.d = self.X.shape[0]
        self.staging = PinnedStaging(device)
        self.device = self.staging.device

    def _cols(self, bids: np.ndarray) -> np.ndarray:
        B = self.bucket
        return (bids[..., None] * B
                + np.arange(B, dtype=np.int32)).reshape(
                    bids.shape[:-1] + (-1,))

    def chunk_specs(self, lead: tuple[int, ...], nb: int, rows=None
                    ) -> dict[str, tuple[tuple[int, ...], np.dtype]]:
        """name -> (shape, dtype) of what `gather_buckets` returns for
        bucket ids of shape (*lead, nb) (`TileCache.chunk_specs`)."""
        lo, hi = rows if rows is not None else (0, self.d)
        rows = tuple(lead) + (nb * self.bucket,)
        if self.sparse:
            nnz = self.idx.shape[1]
            specs = {"idx": (rows + (nnz,), np.int32),
                     "val": (rows + (nnz,), np.float32)}
        else:
            specs = {"X": (rows[:-1] + (hi - lo, rows[-1]), np.float32)}
        specs["y"] = (rows, np.float32)
        return specs

    def gather_buckets(self, bids: np.ndarray, out=None, rows=None):
        """The rows of bucket ids (*lead, nb), into ``out`` (a dict of
        arrays shaped as `chunk_specs` says; new ones when None):
        `TileCache.gather_buckets`'s contract over the host arrays."""
        bids = np.asarray(bids)
        cols = self._cols(bids)
        if out is None:
            out = {k: np.empty(s, dt) for k, (s, dt) in self.chunk_specs(
                bids.shape[:-1], bids.shape[-1], rows).items()}
        np.take(self.y, cols, out=out["y"])
        if self.sparse:
            np.take(self.idx, cols, axis=0, out=out["idx"])
            np.take(self.val, cols, axis=0, out=out["val"])
            return (out["idx"], out["val"]), out["y"]
        X = self.X if rows is None else self.X[rows[0]:rows[1]]
        np.copyto(out["X"], np.moveaxis(X[:, cols], 0, -2))
        return out["X"], out["y"]

    def fetch(self, bids: np.ndarray):
        bids = np.asarray(bids)
        specs = self.chunk_specs(bids.shape[:-1], bids.shape[-1])
        t = self.staging.put(
            specs, lambda bufs: self.gather_buckets(bids, out=bufs))
        if self.sparse:
            return (t["idx"], t["val"]), t["y"]
        return t["X"], t["y"]
