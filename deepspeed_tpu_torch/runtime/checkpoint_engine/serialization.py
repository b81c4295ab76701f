"""Checkpoint serialization: the JAX package's on-disk format.

Own copy of ``deepspeed_tpu/runtime/checkpoint_engine/serialization.py``.
A checkpoint file is a zip (``numpy.savez``) of leaf arrays keyed by
escaped tree paths plus a ``__meta__`` JSON entry (header version 2: the
non-array values, the caller's extra metadata and a CRC32 manifest of
every entry). The bytes and key names are the JAX package's, so a tag
written by either package loads in the other.

Trees here are nested dicts (and lists) of torch tensors or numpy arrays;
a key is the ``/``-joined path, dict keys in sorted order as JAX's dict
flattening gives them. A port parameter ``blocks.wq`` is the JAX path
``blocks/wq``, so the engine's master leaf is ``master/blocks/wq``.

Sharded layout (one ``shard-{rank}.npz`` a process): each rank writes its
own chunks of every leaf, keyed ``{key}#{rank}.0``, with an index entry per
leaf (global shape, dtype, chunk offsets); any process count or ZeRO
stage reassembles the global arrays on load (:func:`load_sharded`).
"""

import glob
import json
import os
import zipfile
import zlib

import numpy as np
import torch

from ...utils import fault_injection, groups


_SEP = "/"


class CheckpointCorruptionError(ValueError):
    """A shard failed integrity verification (truncated zip, CRC
    mismatch, missing manifest entry). Subclasses ValueError so callers
    that already guard reassembly errors catch it too; load paths use
    it to fall back to the previous durable generation."""


def _items(node):
    """(key, child) pairs of a dict (sorted keys, as JAX flattens dicts)
    or a list/tuple (indices); None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _walk(tree, prefix=()):
    items = _items(tree)
    if items is None:
        yield prefix, tree
        return
    for k, v in items:
        yield from _walk(v, prefix + (k,))


# A bfloat16 leaf (optimizer ``moments_dtype="bfloat16"``) has no numpy
# dtype without ml_dtypes, which the port does not import: it travels as
# its two-byte words in a ``V2`` array, written with the npy descr
# ``'<V2'`` that numpy gives an ml_dtypes bfloat16 array (the JAX tag's
# record, byte for byte), and named "bfloat16" in the sharded index, as
# the JAX package names it ``str(leaf.dtype)``.
BF16 = "bfloat16"
_WORDS = np.dtype("V2")


def to_numpy(leaf):
    """A leaf as a host numpy array: a torch tensor is copied to host
    memory (its own copy, never a view of live state); a bfloat16 tensor
    becomes its words as a ``V2`` array."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_WORDS)
        return t.numpy()
    return np.asarray(leaf)


def write_npy(fid, val):
    """``numpy.save``'s npy record of ``val`` into the open file ``fid``,
    with a ``V2`` array's record under the descr ``'<V2'``."""
    val = np.asanyarray(val)
    if val.dtype != _WORDS:
        np.lib.format.write_array(fid, val, allow_pickle=False)
        return
    val = np.ascontiguousarray(val)
    head = {"descr": "<V2", "fortran_order": False, "shape": val.shape}
    try:
        np.lib.format.write_array_header_1_0(fid, head)
    except ValueError:
        np.lib.format.write_array_header_2_0(fid, head)
    fid.write(val.tobytes())


def _savez(file, arrays):
    """``numpy.savez(file, **arrays)`` (the same zip, entries and npy
    records), with a ``V2`` array's record under the descr ``'<V2'``."""
    with zipfile.ZipFile(file, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                write_npy(fid, val)


def _bf16(words):
    """A reassembled ``V2`` / int16 array of bfloat16 words -> a bf16
    tensor (host memory)."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int16)) \
        .view(torch.bfloat16)


def flatten_state(tree):
    """-> (dict path->leaf, meta dict of non-array leaves)."""
    flat = {}
    meta = {}
    for path, leaf in _walk(tree):
        key = _SEP.join(path)
        if isinstance(leaf, (int, float, str, bool)) or leaf is None:
            meta[key] = leaf
        else:
            flat[key] = leaf
    return flat, meta


def unflatten_into(template, flat, meta=None):
    """Rebuild a tree shaped like ``template`` (nested dicts / lists) from
    flat path->array."""
    meta = meta or {}

    def pick(node, path):
        items = _items(node)
        if items is None:
            key = _SEP.join(path)
            if key in flat:
                return flat[key]
            if key in meta:
                return meta[key]
            raise KeyError(f"checkpoint missing key {key}")
        out = {k: pick(v, path + (k,)) for k, v in items}
        if isinstance(node, dict):
            return {k: out[str(k)] for k in node}
        return type(node)(out[str(i)] for i in range(len(node)))

    return pick(template, ())


def _crc(arr):
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.view(np.uint8).reshape(-1)) & 0xFFFFFFFF


def save_file(path, tree, extra_meta=None):
    """Write one shard. Integrity: the header carries a per-entry CRC32
    manifest (verified by load_file). Durability: file-path writes go to
    ``path + ".tmp"``, fsync, then atomic ``os.replace`` — a crash at
    ANY byte of the write leaves the previously durable shard at
    ``path`` untouched (the CheckFreq/VELOC two-phase rule)."""
    fault_injection.fire("serialize")
    flat, meta = flatten_state(tree)
    arrays = {}
    manifest = {}
    for k, v in flat.items():
        arr = to_numpy(v)
        # np.savez keys cannot contain '/': escape
        key = k.replace("/", "%2F")
        arrays[key] = arr
        manifest[key] = _crc(arr)
    header = {"meta": meta, "extra": extra_meta or {}, "version": 2,
              "crc": manifest}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    if hasattr(path, "write"):
        # in-memory target (the native engine serializes to bytes; its
        # C++ pool owns the byte write — and fires 'write' — plus its
        # own tmp/rename)
        _savez(path, arrays)
        return
    tmp = str(path) + ".tmp"
    # re-create the tag dir: a retrying attempt must heal even if the
    # (then-empty) dir was swept by retention GC in between
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    try:
        with open(tmp, "wb") as f:
            fault_injection.fire("write")
            _savez(f, arrays)
            f.flush()
            os.fsync(f.fileno())
        fault_injection.fire("rename")
        os.replace(tmp, path)
    except Exception:
        # a failed attempt must not leak a full-size tmp shard; a
        # SimulatedKill/real crash still leaves one, faithfully to
        # SIGKILL (retention GC sweeps the emptied tag dirs)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(str(path)))


def _fsync_dir(dirpath):
    """Make a rename durable: fsync the containing directory (best
    effort — not all filesystems support directory fds)."""
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def load_file(path, verify=True):
    """-> (flat dict path->array, header dict). ``verify`` checks every
    entry against the header's CRC32 manifest (files written before the
    manifest existed — header version 1 — load unverified)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(bytes(z["__meta__"].tobytes()).decode())
            flat_raw = {k: z[k] for k in z.files if k != "__meta__"}
    except (zipfile.BadZipFile, KeyError, EOFError, OSError,
            ValueError) as e:
        if isinstance(e, FileNotFoundError):
            raise
        raise CheckpointCorruptionError(
            f"checkpoint shard {path} is unreadable "
            f"(truncated or torn write?): {e}") from e
    manifest = header.get("crc")
    if verify and manifest is not None:
        for key in manifest:
            if key not in flat_raw:
                raise CheckpointCorruptionError(
                    f"checkpoint shard {path}: chunk entry {key!r} "
                    f"listed in the CRC manifest but absent from the "
                    f"archive — torn shard")
        for key, arr in flat_raw.items():
            want = manifest.get(key)
            if want is None:
                raise CheckpointCorruptionError(
                    f"checkpoint shard {path}: entry {key!r} absent "
                    f"from the CRC manifest — foreign or tampered data")
            got = _crc(arr)
            if got != want:
                raise CheckpointCorruptionError(
                    f"checkpoint shard {path}: CRC mismatch on "
                    f"{key!r} (want {want:#010x}, got {got:#010x}) — "
                    f"shard is corrupt")
    flat = {k.replace("%2F", "/"): v for k, v in flat_raw.items()}
    return flat, header


# --------------------------------------------------------- sharded layout

def _leaf_entry(shape, dtype):
    return {"shape": [int(s) for s in shape], "dtype": dtype, "chunks": []}


def dtype_name(leaf):
    """The index entry's dtype: numpy's name, "bfloat16" for bf16."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return BF16
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def extract_local_chunks(tree, partition=None, topology=None):
    """-> (chunks dict, index dict, meta dict) for THIS rank.

    ``partition(key)`` gives how the leaf at ``key`` lies over the ranks:
    a list of ``(dim, axes)`` splits, each rank holding the
    ``axis_index(axes)``-th equal slice along each ``dim`` (an expert
    leaf's expert dim, the port's ZeRO plan's partition,
    runtime/zero/partitioning.py); empty for a leaf every rank holds
    whole. A leaf is the GLOBAL array where it is whole and this rank's
    shard otherwise.

    Each global shard is written exactly once across the job: by the
    lowest rank that holds it (the rank at index 0 along every mesh axis
    outside ``axes``; JAX's ``replica_id == 0``), so a replicated leaf is
    written by rank 0, a shard replicated over ``seq`` (dp x seq) or
    ``data_outer`` (MiCS) by the rank at index 0 there. Chunk keys are
    ``{key}#{rank}.0``, the offset the shard's ``start`` along ``dim``.
    Every leaf gets an index entry on every rank, also one without a
    chunk here, so the per-leaf coverage check on load sees every leaf.
    Chunks are host copies (:func:`to_numpy`): never views of state the
    next training step updates in place."""
    topo = topology or groups.get_topology()
    rank = int(topo.rank)
    flat, meta = flatten_state(tree)
    chunks, index = {}, {}
    for key, leaf in flat.items():
        splits = partition(key) if partition else []
        shape = list(leaf.shape)
        for dim, axes in splits:
            shape[dim] *= topo.axis_size(axes)
        entry = _leaf_entry(shape, dtype_name(leaf))
        held = {a for _, axes in splits for a in axes}
        others = [a for a in groups.MESH_AXES if a not in held]
        if all(topo.axis_index(a) == 0 for a in others):
            start = [0] * len(shape)
            for dim, axes in splits:
                start[dim] = topo.axis_index(axes) * int(leaf.shape[dim])
            ck = f"{key}#{rank}.0"
            chunks[ck] = to_numpy(leaf)
            entry["chunks"].append({"key": ck, "start": start})
        index[key] = entry
    return chunks, index, meta


def load_sharded(dirpath):
    """Read every shard-*.npz in ``dirpath`` and reassemble the global
    logical arrays. -> (flat dict path->array, normalized header)."""
    files = sorted(glob.glob(os.path.join(dirpath, "shard-*.npz")))
    if not files:
        raise FileNotFoundError(f"no shard-*.npz under {dirpath}")
    return load_shard_files(files, where=dirpath)


def load_shard_files(files, where=None):
    """Reassemble the global logical arrays from an explicit list of
    shard file paths. -> (flat dict path->array, normalized header); a
    leaf the index names "bfloat16" comes back as a bf16 tensor."""
    where = where or (os.path.dirname(files[0]) if files else "<empty>")
    merged = {}
    all_chunks = {}
    header0 = header = None
    for f in files:
        flat, header = load_file(f)
        for k, e in (header["extra"].get("index") or {}).items():
            cur = merged.setdefault(
                k, {"shape": e["shape"], "dtype": e["dtype"], "chunks": []})
            cur["chunks"].extend(e["chunks"])
        all_chunks.update(flat)
        if os.path.basename(f) == "shard-0.npz":
            header0 = header
    header0 = header0 or header
    # Coverage validation: the reassembly buffer is np.empty, so any gap
    # (missing shard file, partial copy, mismatched process count) would
    # silently resume training from uninitialized memory. Check the shard
    # file count against the writer's recorded world size, then require
    # every leaf's chunks to cover it exactly.
    nprocs = (header0["extra"].get("user_extra") or {}).get("nprocs")
    if nprocs is not None and len(files) != nprocs:
        raise ValueError(
            f"incomplete checkpoint {where}: found {len(files)} shard "
            f"files but the writer recorded nprocs={nprocs}")
    out = {}
    for k, e in merged.items():
        total = int(np.prod(e["shape"], dtype=np.int64))
        filled = 0
        bf16 = e["dtype"] == BF16
        arr = np.empty(e["shape"], np.int16 if bf16 else np.dtype(e["dtype"]))
        for c in e["chunks"]:
            if c["key"] not in all_chunks:
                raise ValueError(
                    f"checkpoint {where}: leaf {k} chunk {c['key']} "
                    f"indexed but absent from every shard file")
            data = all_chunks[c["key"]]
            if bf16:
                data = data.view(np.int16)
            sl = tuple(slice(s, s + n) for s, n in zip(c["start"],
                                                       data.shape))
            arr[sl] = data
            filled += data.size
        if filled != total:
            raise ValueError(
                f"checkpoint {where}: leaf {k} covered by "
                f"{filled}/{total} elements — shard files missing or "
                f"written by a torn save")
        out[k] = _bf16(arr) if bf16 else arr
    extra = dict(header0["extra"])
    meta = extra.pop("__tree_meta__", {})
    extra.pop("index", None)
    return out, {"meta": meta, "extra": extra.get("user_extra", extra)}


def load_state(tag_dir):
    """Load a checkpoint tag directory in either layout: legacy monolithic
    ``state.npz`` (global arrays, one writer) or the sharded per-rank
    layout. -> (flat dict, header with 'meta'/'extra')."""
    legacy = os.path.join(tag_dir, "state.npz")
    if os.path.exists(legacy):
        return load_file(legacy)
    return load_sharded(tag_dir)


def verify_tag(tag_dir):
    """Full integrity pass over one tag directory: every shard's zip
    structure + CRC manifest, and (sharded layout) chunk coverage of
    every leaf + the writer's recorded nprocs. Raises
    CheckpointCorruptionError / ValueError / FileNotFoundError on any
    defect; returns True when the generation is known-good. Retention
    GC calls this on the NEWEST tag before deleting older ones, so
    recovery always has a loadable generation. It holds one shard in
    memory at a time and checks coverage arithmetically."""
    legacy = os.path.join(tag_dir, "state.npz")
    if os.path.exists(legacy):
        load_file(legacy)
        return True
    files = sorted(glob.glob(os.path.join(tag_dir, "shard-*.npz")))
    if not files:
        raise FileNotFoundError(f"no shard files under {tag_dir}")
    chunk_sizes = {}
    merged = {}
    header0 = header = None
    for f in files:
        flat, header = load_file(f)   # zip structure + CRC manifest
        for k, arr in flat.items():
            chunk_sizes[k] = int(arr.size)
        for k, e in (header["extra"].get("index") or {}).items():
            cur = merged.setdefault(k, {"shape": e["shape"],
                                        "chunks": []})
            cur["chunks"].extend(c["key"] for c in e["chunks"])
        if os.path.basename(f) == "shard-0.npz":
            header0 = header
        del flat
    header0 = header0 or header
    nprocs = (header0["extra"].get("user_extra") or {}).get("nprocs")
    if nprocs is not None and len(files) != nprocs:
        raise ValueError(
            f"incomplete checkpoint {tag_dir}: found {len(files)} shard "
            f"files but the writer recorded nprocs={nprocs}")
    for k, e in merged.items():
        total = int(np.prod(e["shape"], dtype=np.int64))
        filled = 0
        for ck in e["chunks"]:
            if ck not in chunk_sizes:
                raise ValueError(
                    f"checkpoint {tag_dir}: leaf {k} chunk {ck} indexed "
                    f"but absent from every shard file")
            filled += chunk_sizes[ck]
        if filled != total:
            raise ValueError(
                f"checkpoint {tag_dir}: leaf {k} covered by "
                f"{filled}/{total} elements — shard files missing or "
                f"written by a torn save")
    return True
