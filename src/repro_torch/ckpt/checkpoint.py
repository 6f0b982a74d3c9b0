"""Sharded, atomic, async checkpointing of trees of tensors: the port of
`repro.ckpt.checkpoint`, with the same on-disk format, so that a training
job checkpointed by either package resumes in the other.

Format: ``<dir>/step_<N>/`` holds a ``manifest.json`` (step, leaf paths,
shapes, dtypes, the shard of each leaf, ``extra``, codec) and one
compressed msgpack shard a ~256 MB run of leaves, each item
``{"path", "data"}`` with ``data`` the leaf's bytes in C order.  A
``COMMIT`` marker written last makes a save atomic: a crashed save is an
ignorable partial directory.  Leaf paths join the tree's keys and list
positions by ``/`` in sorted-key order, as `jax.tree_util` flattens a dict;
that order decides which shard a leaf lands in.

Types are named as numpy names them (``"bfloat16"`` as ml_dtypes names
it); the port moves bf16 bytes through an ``int16`` view and keeps its own
table of names, so it needs neither JAX nor ml_dtypes.  The codec is zstd
where `zstandard` is installed, else zlib; reading a zstd checkpoint
without `zstandard` raises.  msgpack holds at most 4 GiB in one bin, so a
larger leaf cannot be saved (in either package).

Shards are compressed and inflated on several host cores: each shard is
compressed on its own, and both codecs release the interpreter lock, so a
pool of threads (one a core this process may run on) works on the next
shards while the calling thread copies, packs and writes, or unpacks, in
shard order.  Every file is byte for byte what one thread would write; at
most one shard a thread is in flight (~256 MB of payload and its
compressed bytes each).

`restore` takes a tree of tensors, or of ``meta`` tensors (`state_shapes`),
and puts each leaf on ``device`` shard by shard as it reads.  `save` and
`restore` take an optional ``stats`` dict, into which they add the seconds
of each stage and the bytes moved (what a relocation's cost is made of);
every stage's seconds are the calling thread's wall time, so that they add
up to the call's.

A sharded state moves like a whole one.  `save` and
`CheckpointManager.save_async` take a tree of DTensors: every rank of the
mesh gathers each leaf (a collective), and the mesh's first rank writes
it, so the files hold whole arrays and a job's layout is never on disk.
`restore(..., placements=)` (the reference's ``shardings``) reads each
leaf on the host on every rank and keeps the rank's shard of it, as a
DTensor in the leaf's `parallel.sharding.Layout`: a job saved on one mesh
resumes on another.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import json
import os
import re
import shutil
import tempfile
import time
import warnings
import zlib
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

import msgpack
import torch

from .._tree import tree_items, tree_map, tree_map_with_path

try:  # pragma: no cover - availability depends on the environment
    import zstandard
except ImportError:  # stdlib zlib: slower, no extra dependency
    zstandard = None

_COMMIT = "COMMIT"
_SHARD_BYTES = 256 * 1024 * 1024  # flush a shard file at ~256 MB
_DEFAULT_CODEC = "zstd" if zstandard is not None else "zlib"
_CODEC_EXT = {"zstd": "zst", "zlib": "zz"}
_MAX_BIN = 2 ** 32 - 1            # msgpack's largest bin

# numpy's name of each type -> the torch type; a leaf's bytes are its
# elements' bytes, so a name's item size is the torch type's.
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {t: name for name, t in _DTYPES.items()}


def _compress_fn(codec: str):
    """The codec's compression of one payload, safe to call from several
    threads at once (a zstd compressor object is not: one is made a call)."""
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError("zstd checkpoint requested but zstandard not installed")
        return lambda payload: zstandard.ZstdCompressor(level=3).compress(payload)
    if codec == "zlib":
        return lambda payload: zlib.compress(payload, 6)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _decompress_fn(codec: str):
    """As `_compress_fn`, the way back."""
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd but zstandard is not installed"
            )
        return lambda packed: zstandard.ZstdDecompressor().decompress(packed)
    if codec == "zlib":
        return zlib.decompress
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _host_cores() -> int:
    """The cores this process may run on: the shard pool's threads."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:                   # no affinity call on this platform
        return os.cpu_count() or 1


def _shard_name(shard_id: int, codec: str) -> str:
    return f"shard_{shard_id:04d}.msgpack.{_CODEC_EXT[codec]}"


def _flat(tree: Any) -> List[Tuple[str, Any]]:
    """(leaf path joined by ``/``, leaf) in the reference's order."""
    return list(tree_items(tree, sep="/"))


def _itemsize(name: str) -> int:
    if name not in _DTYPES:
        raise ValueError(f"checkpoint leaf type {name!r} is not one the port reads")
    return torch.empty((), dtype=_DTYPES[name]).element_size()


def _nbytes(shape, name: str) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * _itemsize(name)


def tree_nbytes(tree: Any) -> int:
    """Checkpoint payload bytes of ``tree``: tensors, ``meta`` tensors (the
    `train.state_shapes` tree) or anything with ``.shape`` and a numpy-named
    ``.dtype``.  This is the exact uncompressed byte count `save` writes, so
    a migration's state transfer can be sized without the state."""
    total = 0
    for _, leaf in _flat(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += _nbytes(getattr(leaf, "shape", ()), str(getattr(leaf, "dtype", "float32")))
    return total


def shard_count(nbytes: int) -> int:
    """Number of shard files `save` would emit for ``nbytes`` of payload
    (one per ~`_SHARD_BYTES` flush, minimum one)."""
    return max(1, -(-int(nbytes) // _SHARD_BYTES))


def checkpoint_nbytes(path: str) -> Tuple[int, int]:
    """(payload bytes, shard-file count) of a committed checkpoint, from its
    manifest: the byte count a cross-node migration copies."""
    total = 0
    shards = set()
    for leaf in _read_manifest(path)["leaves"]:
        total += _nbytes(leaf["shape"], leaf["dtype"])
        shards.add(leaf["shard"])
    return total, max(len(shards), 1)


def _mesh_of(tree: Any):
    """The DeviceMesh of a tree's DTensor leaves, or None for a tree of
    plain tensors."""
    from ..parallel.comm import is_dtensor

    for _, leaf in _flat(tree):
        if is_dtensor(leaf):
            return leaf.device_mesh
    return None


def _writes(mesh) -> bool:
    """Whether this rank writes the mesh's checkpoints: the first of the mesh."""
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


def _gathered(tree: Any, mesh) -> Any:
    """Host copies of ``tree``'s whole leaves on the writing rank (None on
    the others); every rank of the mesh gathers, leaf by leaf."""
    from ..parallel.comm import is_dtensor

    writer = _writes(mesh)

    def one(t):
        whole = t.full_tensor() if is_dtensor(t) else t
        return _host_copy(whole) if writer else None

    out = tree_map(one, tree)
    return out if writer else None


def _mesh_barrier(mesh) -> None:
    """Every rank of the mesh has come here (a sum over each mesh dim in
    turn)."""
    from ..parallel.comm import all_reduce_, mesh_device

    all_reduce_(torch.zeros(1, device=mesh_device(mesh)), mesh, range(mesh.ndim))


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t`` that later in-place updates of ``t``
    (the port's optimizers) do not reach; waits for the device."""
    return t.detach().to("cpu", copy=True).contiguous()


def _leaf_bytes(path: str, t: torch.Tensor) -> bytes:
    if t.numel() * t.element_size() > _MAX_BIN:
        raise ValueError(f"checkpoint leaf {path} holds {t.numel() * t.element_size()} bytes: "
                         "msgpack stores at most 4 GiB in one item")
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _add(stats: Optional[Dict], key: str, value) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + value


def save(directory: str, step: int, tree: Any, extra: Optional[Dict] = None,
         stats: Optional[Dict] = None) -> str:
    """Synchronous atomic save; returns the checkpoint path.  Leaves on a
    device are copied to the host one at a time; each full shard is packed
    and handed to the pool to compress, and written once compressed, in
    shard order.  ``stats`` gains the seconds of ``to_host`` (device-to-host
    copy and leaf bytes), ``pack`` (msgpack), ``compress`` (waiting for the
    pool: compression not hidden behind the other stages) and ``write``,
    and ``payload_bytes`` and ``file_bytes``."""
    final = os.path.join(directory, f"step_{step:08d}")
    mesh = _mesh_of(tree)
    if mesh is not None:
        tree = _gathered(tree, mesh)
        if tree is None:                    # another rank writes
            _mesh_barrier(mesh)
            return final
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory or ".")
    codec = _DEFAULT_CODEC
    manifest: Dict[str, Any] = {
        "step": step,
        "treedef": None,  # reconstructed from leaf paths
        "leaves": [],
        "extra": extra or {},
        "codec": codec,
    }
    compress = _compress_fn(codec)
    workers = _host_cores()
    shard_id, buf, buf_bytes = 0, [], 0
    in_flight: Deque[Tuple[int, cf.Future]] = collections.deque()  # oldest first

    def write_oldest():
        shard, future = in_flight.popleft()
        t0 = time.perf_counter()
        packed = future.result()
        t1 = time.perf_counter()
        with open(os.path.join(tmp, _shard_name(shard, codec)), "wb") as f:
            f.write(packed)
        _add(stats, "compress", t1 - t0)
        _add(stats, "write", time.perf_counter() - t1)
        _add(stats, "file_bytes", len(packed))

    def flush(pool):
        nonlocal shard_id, buf, buf_bytes
        if not buf:
            return
        if len(in_flight) == workers:
            write_oldest()
        t0 = time.perf_counter()
        payload = msgpack.packb(buf, use_bin_type=True)
        _add(stats, "pack", time.perf_counter() - t0)
        in_flight.append((shard_id, pool.submit(compress, payload)))
        shard_id += 1
        buf, buf_bytes = [], 0

    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        for path, leaf in _flat(tree):
            t0 = time.perf_counter()
            t = leaf.detach().cpu()
            if t.dtype not in _NAMES:
                raise ValueError(f"checkpoint leaf {path}: type {t.dtype} has no numpy name")
            manifest["leaves"].append({
                "path": path,
                "shape": list(t.shape),
                "dtype": _NAMES[t.dtype],
                "shard": shard_id,
            })
            buf.append({"path": path, "data": _leaf_bytes(path, t.contiguous())})
            buf_bytes += t.numel() * t.element_size()
            _add(stats, "to_host", time.perf_counter() - t0)
            _add(stats, "payload_bytes", t.numel() * t.element_size())
            if buf_bytes >= _SHARD_BYTES:
                flush(pool)
        flush(pool)
        while in_flight:
            write_oldest()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if mesh is not None:
        _mesh_barrier(mesh)
    return final


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """Committed checkpoints, ascending by step."""
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        path = os.path.join(directory, name)
        if m and os.path.exists(os.path.join(path, _COMMIT)):
            out.append((int(m.group(1)), path))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[str]:
    cks = list_checkpoints(directory)
    return cks[-1][1] if cks else None


def _read_manifest(path: str) -> Dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _iter_leaves(path: str, stats: Optional[Dict] = None) -> Iterator[Tuple[str, torch.Tensor]]:
    """(leaf path, host tensor) shard by shard; each tensor is a view of its
    shard's bytes, read-only in spirit: copy before writing to it.  The
    pool inflates the next shards while the caller takes this one's leaves.
    ``stats`` gains the seconds of ``read``, ``decompress`` (waiting for
    the pool) and ``unpack``, and ``file_bytes``."""
    manifest = _read_manifest(path)
    codec = manifest.get("codec", "zstd")  # pre-codec checkpoints were zstd
    decompress = _decompress_fn(codec)
    by_shard: Dict[int, List[Dict]] = {}
    for leaf in manifest["leaves"]:
        by_shard.setdefault(leaf["shard"], []).append(leaf)
    order = list(by_shard)
    workers = _host_cores()
    in_flight: Deque[cf.Future] = collections.deque()  # oldest first

    def read(shard):
        t0 = time.perf_counter()
        with open(os.path.join(path, _shard_name(shard, codec)), "rb") as f:
            packed = f.read()
        _add(stats, "read", time.perf_counter() - t0)
        _add(stats, "file_bytes", len(packed))
        in_flight.append(pool.submit(decompress, packed))

    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        ahead = iter(order)
        for shard in order:
            for later in ahead:
                read(later)
                if len(in_flight) == workers:
                    break
            t0 = time.perf_counter()
            payload = in_flight.popleft().result()
            t1 = time.perf_counter()
            items = msgpack.unpackb(payload, raw=False)
            _add(stats, "decompress", t1 - t0)
            _add(stats, "unpack", time.perf_counter() - t1)
            del payload
            data = {i["path"]: i["data"] for i in items}
            del items
            for leaf in by_shard[shard]:
                raw = data[leaf["path"]]
                dtype = _DTYPES[leaf["dtype"]]
                with warnings.catch_warnings():      # bytes are not writable; callers copy
                    warnings.simplefilter("ignore", UserWarning)
                    flat = (torch.frombuffer(raw, dtype=dtype) if raw
                            else torch.empty(0, dtype=dtype))
                yield leaf["path"], flat.reshape(leaf["shape"])


def _load_raw(path: str) -> Dict[str, torch.Tensor]:
    """Every leaf of a checkpoint as a host tensor, by leaf path."""
    return {p: t.clone() for p, t in _iter_leaves(path)}


def restore(path: str, like: Any, device=None, stats: Optional[Dict] = None,
            placements: Any = None) -> Any:
    """Restore into the structure of ``like`` (tensors or ``meta`` tensors):
    each leaf is cast to its ``like`` leaf's type, checked against its shape
    and put on ``device`` (by default the ``like`` leaf's device, the host
    for a ``meta`` leaf) as its shard is read.  With ``placements``, a tree
    of `parallel.sharding.Layout` matching ``like`` (the reference's
    ``shardings``), each leaf becomes a DTensor on its layout's mesh
    holding this rank's shard, on the mesh's device.  ``stats`` gains the
    stages of `_iter_leaves`, ``to_device`` seconds and ``payload_bytes``."""
    want = dict(_flat(like))
    where = dict(_flat(placements)) if placements is not None else {}
    placed: Dict[str, torch.Tensor] = {}
    for key, t in _iter_leaves(path, stats):
        if key not in want:
            continue
        leaf = want[key]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: ckpt shape {tuple(t.shape)} != target {tuple(leaf.shape)}")
        target = device if device is not None else (
            "cpu" if leaf.device.type == "meta" else leaf.device)
        t0 = time.perf_counter()
        if key in where:
            placed[key] = _placed(t, leaf.dtype, where[key])
        else:
            placed[key] = t.to(device=target, dtype=leaf.dtype, copy=True)
        if placed[key].is_cuda:
            torch.cuda.synchronize(placed[key].device)
        _add(stats, "to_device", time.perf_counter() - t0)
        _add(stats, "payload_bytes", t.numel() * t.element_size())
    for key in want:
        if key not in placed:
            raise KeyError(f"checkpoint missing leaf {key}")
    return tree_map_with_path(lambda key, _: placed[key], like, sep="/")


def _placed(t: torch.Tensor, dtype, layout) -> torch.Tensor:
    """A DTensor of this rank's shard of the host tensor ``t``."""
    from torch.distributed.tensor import DTensor

    from ..parallel.comm import mesh_device
    from ..parallel.sharding import local_chunk

    part = local_chunk(t, layout).to(device=mesh_device(layout.mesh), dtype=dtype, copy=True)
    return DTensor.from_local(part.contiguous(), layout.mesh, layout.placements,
                              run_check=False)


def read_extra(path: str) -> Dict:
    return _read_manifest(path).get("extra", {})


class CheckpointManager:
    """Async save (background thread), retention, and latest-restore.

    `save_async` copies the tree to the host before it returns (the port's
    optimizers update the state in place, so a copy left in flight would
    write a later step's state under this step's name); compression and
    IO run in the background.  ``last_snapshot_s`` keeps the seconds of the
    newest snapshot (the pause the job sees); ``last_save`` and
    ``last_restore`` the stages of the newest background save and restore
    (`save`'s and `restore`'s ``stats``, with their total ``seconds``)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None
        self._mesh = None                # of the newest save, if it was sharded
        self.last_snapshot_s: Optional[float] = None
        self.last_save: Optional[Dict] = None
        self.last_restore: Optional[Dict] = None

    def snapshot(self, tree: Any) -> Any:
        """The host copy that `save_async` hands to the background save: of
        a tree of DTensors, the whole leaves on the mesh's writing rank and
        None on the others (every rank gathers)."""
        mesh = _mesh_of(tree)
        if mesh is not None:
            return _gathered(tree, mesh)
        return tree_map(_host_copy, tree)

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.wait()
        t0 = time.perf_counter()
        self._mesh = _mesh_of(tree)
        host_tree = self.snapshot(tree)
        self.last_snapshot_s = time.perf_counter() - t0
        if host_tree is not None:
            self._pending = self._pool.submit(self._save_and_gc, step, host_tree, extra)

    def _save_and_gc(self, step, tree, extra):
        t0 = time.perf_counter()
        stats: Dict = {}
        path = save(self.directory, step, tree, extra, stats)
        cks = list_checkpoints(self.directory)
        for _, old in cks[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)
        self.last_save = dict(stats, seconds=time.perf_counter() - t0)
        return path

    def wait(self) -> None:
        """Until the newest save is committed; after a sharded save, on
        every rank of its mesh (each must call this)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            _mesh_barrier(mesh)

    def restore_latest(self, like, device=None, placements=None):
        self.wait()
        path = latest_checkpoint(self.directory)
        if path is None:
            return None
        t0 = time.perf_counter()
        stats: Dict = {}
        state = restore(path, like, device, stats, placements)
        self.last_restore = dict(stats, seconds=time.perf_counter() - t0)
        return state, read_extra(path)
