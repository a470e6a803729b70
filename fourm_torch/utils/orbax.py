"""The JAX package's orbax checkpoints, read and written without orbax: the
port's counterpart of the on-disk format of fourm_tpu/utils/checkpoint.py:
31-82 (`save_checkpoint` through orbax's StandardCheckpointer).

A `step_N` directory that orbax writes holds
  * `_METADATA`: JSON whose `tree_metadata` maps each leaf's key path (dict
    keys, sequence indices) to its value type and shape;
  * `_CHECKPOINT_METADATA`: JSON of the handler and the commit time;
  * an OCDBT key-value store (tensorstore's "optionally-cooperative
    distributed B+tree"): `manifest.ocdbt` at the root names the newest
    version's b-tree root; nodes and values live in data files under `d/`
    and, for a store written by several processes, `ocdbt.process_N/d/`.
    Each manifest and node is framed by a magic number, its length, a format
    version and a compression format (none or zstd), and ends with a
    CRC-32C of the rest. Values of up to `max_inline_value_bytes` sit in
    their leaf node; larger ones are (data file, offset, length) references;
  * in that store, one zarr v2 array per leaf: `<path>/.zarray` (JSON: dtype,
    shape, chunks, compressor, fill value) and one key per chunk
    (`<path>/0.0`), where `<path>` joins the key path with ".". An array
    that was sharded over a mesh arrives in several chunks.

`read_orbax_tree` reads such a directory into nested dicts of numpy arrays
(sequence entries keyed by their int index; a leaf stored as None is None).
It checks every CRC-32C and zstd checksum and raises, naming the key and what
it found, on what it does not read: zarr v3, numbered manifests, a filter, a
compressor other than zstd, dtypes other than <f4, <f8, bfloat16, <f2, <i4,
<i8, <u4 and |b1, or a data file that is missing (a multi-process write that
was never merged). bfloat16 arrays come back widened to float32 (exactly;
numpy has no bfloat16). zstd is decoded by the native library
(fourm_torch/native, built with g++ at first use).

`write_orbax_tree` writes a tree of numpy arrays, torch tensors (bfloat16
too), numbers and None as one process's single-version OCDBT store with
uncompressed nodes and one uncompressed chunk an array, values inline below
1024 bytes: what `ocp.StandardCheckpointer().restore(path, abstract_state)`
restores, so the JAX package's `load_checkpoint` reads it.
"""

from __future__ import annotations

import base64
import itertools
import json
import math
import mmap
import os
import shutil
import time
import uuid
from typing import Any, Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
_NO_ROOT = 2 ** 64 - 1  # the offset / length of an empty version's root
# JAX's name of the device a written array is recorded on, the CPU's first:
# a JAX process on the CPU finds it among its local devices; one on another
# backend restores with shardings of its own (as train_4m's resume does)
SHARDING_DEVICE = "TFRT_CPU_0"

# zarr v2 dtype -> the numpy dtype it is stored in ("bfloat16": its bits)
_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<f2": np.float16, "bfloat16": np.uint16,
           "<i4": np.int32, "<i8": np.int64, "<u4": np.uint32, "|b1": np.bool_}
_ZARR_NAMES = {np.dtype(v): k for k, v in _DTYPES.items() if k != "bfloat16"}
_SEQUENCE, _DICT = 1, 2  # orbax's key types


def is_orbax_step(path: str) -> bool:
    """Whether `path` is a step directory that orbax wrote with OCDBT."""
    return (os.path.isfile(os.path.join(path, "_METADATA"))
            and os.path.isfile(os.path.join(path, "manifest.ocdbt")))


# ------------------------------------------------------------------ framing

class _Cursor:
    def __init__(self, buf: bytes, what: str):
        self.b, self.p, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.b):
            raise ValueError(f"{self.what}: truncated ({n} bytes wanted at {self.p} of "
                             f"{len(self.b)})")
        out = self.b[self.p:self.p + n]
        self.p += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: a varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _unframe(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or b-tree node: magic, length, version 0,
    compression format, body, CRC-32C."""
    from ..native import crc32c, decode_zstd

    if len(raw) < 18 or int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"{what}: not an OCDBT {'manifest' if magic == MANIFEST_MAGIC else 'node'}"
                         f" (magic {raw[:4].hex()}, {len(raw)} bytes)")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"{what}: its header says {length} bytes, {len(raw)} were read")
    want, got = int.from_bytes(raw[-4:], "little"), crc32c(raw[:-4])
    if want != got:
        raise ValueError(f"{what}: CRC-32C mismatch (stored {want:08x}, computed {got:08x})")
    c = _Cursor(raw[12:-4], what)
    version, fmt = c.varint(), c.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version} (this reader knows 0)")
    body = raw[12 + c.p:-4]
    if fmt == 0:
        return body
    if fmt == 1:
        return decode_zstd(body, name=what).tobytes()
    raise ValueError(f"{what}: compression format {fmt} (0 none or 1 zstd)")


def _frame(body: bytes, magic: int) -> bytes:
    from ..native import crc32c

    head = magic.to_bytes(4, "big")
    rest = _varint(0) + _varint(0) + body  # version 0, uncompressed
    raw = head + (4 + 8 + len(rest) + 4).to_bytes(8, "little") + rest
    return raw + crc32c(raw).to_bytes(4, "little")


def _read_files(c: _Cursor) -> List[str]:
    """A data file table: the paths, prefix-coded, each a base path and a
    relative path joined."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix, _base = c.varints(n), c.varints(n)
    out, prev = [], b""
    for i in range(n):
        prev = prev[:prefix[i]] + c.take(suffix[i])
        out.append(prev.decode())
    return out


def _files_table(paths: Sequence[str]) -> bytes:
    enc = [p.encode() for p in paths]
    prefix = [os.path.commonprefix([a, b]) for a, b in zip(enc, enc[1:])]
    return (_varint(len(enc)) + _varints(len(p) for p in prefix)
            + _varints(len(e) - (len(prefix[i - 1]) if i else 0) for i, e in enumerate(enc))
            + _varints(0 for _ in enc)
            + b"".join(e[len(prefix[i - 1]) if i else 0:] for i, e in enumerate(enc)))


# ------------------------------------------------------------------ reading

class _Ocdbt:
    """The newest version of an OCDBT store at `root`."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{root}: no manifest.ocdbt (a multi-process write that "
                                    "was never finalized, or not an OCDBT store)")
        with open(path, "rb") as f:
            c = _Cursor(_unframe(f.read(), MANIFEST_MAGIC, path), path)
        c.take(16)  # uuid
        kind = c.varint()
        if kind != 0:
            raise ValueError(f"{path}: a numbered manifest (kind {kind}); this reader takes "
                             "the single manifest orbax writes")
        c.varint()  # max_inline_value_bytes
        c.varint()  # max_decoded_node_bytes
        c.u8()  # version_tree_arity_log2
        comp = c.varint()
        if comp == 1:
            c.take(4)  # zstd level
        elif comp != 0:
            raise ValueError(f"{path}: compression method {comp} (0 none or 1 zstd)")
        files = _read_files(c)
        n = c.varint()
        gen, height = c.varints(n), [c.u8() for _ in range(n)]
        fid, off, length = c.varints(n), c.varints(n), c.varints(n)
        # then num_keys, num_tree_bytes, num_indirect_value_bytes, commit_time,
        # and references to the version tree's nodes (older versions)
        if not n:
            raise ValueError(f"{path}: no versions")
        v = max(range(n), key=gen.__getitem__)
        self.root_ref = (None if off[v] == _NO_ROOT
                         else (files[fid[v]], off[v], length[v], height[v]))
        self._maps: Dict[str, mmap.mmap] = {}

    def _bytes(self, file: str, offset: int, length: int, key: str = ""):
        mm = self._maps.get(file)
        if mm is None:
            path = os.path.join(self.root, file)
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"{self.root}: {key or 'a b-tree node'} is in {file}, which is missing (a "
                    "multi-process write whose files are not all here?)")
            with open(path, "rb") as f:
                mm = self._maps[file] = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        if offset + length > len(mm):
            raise ValueError(f"{self.root}/{file}: {key or 'a node'} at {offset}+{length} past "
                             f"its {len(mm)} bytes")
        return np.frombuffer(mm, np.uint8, count=length, offset=offset)

    def items(self, want: bytes = b"") -> Dict[bytes, Any]:
        """{key: inline bytes or (file, offset, length)} of every key that
        starts with `want`; subtrees outside it are not read."""
        out: Dict[bytes, Any] = {}
        if self.root_ref is not None:
            file, off, length, height = self.root_ref
            self._node(file, off, length, height, b"", want, out)
        return out

    def _node(self, file, off, length, height, prefix: bytes, want: bytes, out) -> None:
        what = f"{self.root}/{file}@{off}"
        c = _Cursor(_unframe(self._bytes(file, off, length).tobytes(), NODE_MAGIC, what), what)
        h = c.u8()
        if h != height:
            raise ValueError(f"{what}: a node of height {h} where {height} was expected")
        files = _read_files(c)
        n = c.varint()
        pre = [0] + c.varints(n - 1) if n else []
        suf = c.varints(n)
        common = c.varints(n) if h else None
        keys, prev = [], b""
        for i in range(n):
            prev = prev[:pre[i]] + c.take(suf[i])
            keys.append(prev)
        if h == 0:
            lens, kinds = c.varints(n), c.varints(n)
            n_ind = kinds.count(1)
            fids, offs = c.varints(n_ind), c.varints(n_ind)
            j = 0
            for key, ln, kind in zip(keys, lens, kinds):
                full = prefix + key
                if kind == 0:
                    value = c.take(ln)
                elif kind == 1:
                    value = (files[fids[j]], offs[j], ln)
                    j += 1
                else:
                    raise ValueError(f"{what}: value kind {kind} of {full!r}")
                if full.startswith(want):
                    out[full] = value
            return
        fids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
        for i in range(n):
            lo = prefix + keys[i]
            hi = prefix + keys[i + 1] if i + 1 < n else None
            if (hi is not None and hi <= want) or (lo > want and not lo.startswith(want)):
                continue  # the child holds no key that starts with `want`
            self._node(files[fids[i]], offs[i], lens[i], h - 1, prefix + keys[i][:common[i]],
                       want, out)

    def value(self, v, key: str):
        """A value's bytes (a numpy uint8 view for an indirect one)."""
        return np.frombuffer(v, np.uint8) if isinstance(v, bytes) else self._bytes(*v, key=key)

    def close(self) -> None:
        for mm in self._maps.values():
            try:
                mm.close()
            except BufferError:  # a caller still holds a view: unmapped when it goes
                pass
        self._maps.clear()


def _fill(meta: dict, key: str):
    v = meta.get("fill_value")
    if v is None:
        return 0
    if isinstance(v, str):
        named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if v not in named:
            raise ValueError(f"{key}: fill_value {v!r}")
        return named[v]
    return v


def _array(store: _Ocdbt, path: str, values: Mapping[bytes, Any]) -> np.ndarray:
    """The zarr v2 array at `path`, its chunks assembled."""
    key = f"{path}/.zarray"
    raw = values.get(key.encode())
    if raw is None:
        raise KeyError(f"{store.root}: no {key} in the OCDBT store")
    meta = json.loads(store.value(raw, key).tobytes())
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{key}: zarr_format {meta.get('zarr_format')} (this reader takes 2)")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{key}: order {meta['order']!r} (this reader takes 'C')")
    if meta.get("filters"):
        raise ValueError(f"{key}: filters {meta['filters']} (this reader takes none)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{key}: compressor {comp} (this reader takes zstd or none)")
    name = meta.get("dtype")
    if name not in _DTYPES:
        raise ValueError(f"{key}: dtype {name!r} (this reader takes {', '.join(_DTYPES)})")
    dtype = np.dtype(_DTYPES[name])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape):
        raise ValueError(f"{key}: chunks {list(chunks)} for shape {list(shape)}")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    fill = _fill(meta, key)
    for idx in itertools.product(*map(range, grid)):
        ckey = f"{path}/{sep.join(map(str, idx)) if shape else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        v = values.get(ckey.encode())
        if v is None:  # a chunk orbax did not store holds the fill value
            out[region] = fill
            continue
        whole = out if chunks == shape else np.empty(chunks, dtype)
        data = store.value(v, ckey)
        if comp is not None:
            from ..native import decode_zstd

            decode_zstd(data, out=whole, name=f"{store.root}: {ckey}")
        else:
            if data.size != whole.nbytes:
                raise ValueError(f"{ckey}: {data.size} bytes, a chunk of {list(chunks)} {name} "
                                 f"is {whole.nbytes}")
            whole.reshape(-1).view(np.uint8)[:] = data
        if whole is not out:
            out[region] = whole[tuple(slice(0, r.stop - r.start) for r in region)]
    if name == "bfloat16":  # exact widening of its bits
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


def _metadata(step_dir: str) -> dict:
    path = os.path.join(step_dir, "_METADATA")
    with open(path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: a zarr3 checkpoint (this reader takes zarr v2)")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: a checkpoint without OCDBT (this reader takes OCDBT)")
    return meta


def read_orbax_tree(step_dir: str, prefix: Sequence = ()) -> Dict:
    """A step directory that orbax wrote -> nested dicts of numpy arrays,
    keyed as its `_METADATA` gives the key paths (dict keys as strings,
    sequence entries by int index). `prefix` (e.g. ("params",)) reads only
    the leaves under that path, and returns the whole tree's shape above
    them."""
    meta = _metadata(step_dir)
    want_keys = tuple(str(k) for k in prefix)
    leaves = []
    for entry in meta["tree_metadata"].values():
        km = entry["key_metadata"]
        keys = tuple(k["key"] for k in km)
        if keys[:len(want_keys)] == want_keys:
            leaves.append((keys, [k["key_type"] for k in km], entry["value_metadata"]))
    if prefix and not leaves:
        raise KeyError(f"{step_dir}: no leaf under {list(want_keys)}")
    store = _Ocdbt(step_dir)
    try:
        values = store.items(".".join(want_keys).encode())
        tree: Dict = {}
        for keys, types, vm in sorted(leaves):
            leaf = (None if vm.get("value_type") == "None"
                    else _array(store, ".".join(keys), values))
            node = tree
            path = [int(k) if t == _SEQUENCE else k for k, t in zip(keys, types)]
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return tree
    finally:
        store.close()


# ------------------------------------------------------------------ writing

def _flatten(tree, keys=()) -> Iterator[Tuple[tuple, Any]]:
    """(((key, key_type), ...), leaf) in the tree's order."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, keys + ((str(k), _SEQUENCE if isinstance(k, int) else _DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, keys + ((str(i), _SEQUENCE),))
    else:
        yield keys, tree


def _zarr_array(value, key: str) -> Tuple[np.ndarray, str]:
    """(C-contiguous array to write, zarr dtype name) of a leaf."""
    import torch

    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(value)
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        if arr.dtype.name == "bfloat16":  # an ml_dtypes array
            return arr.view(np.uint16), "bfloat16"
    name = _ZARR_NAMES.get(arr.dtype)
    if name is None:
        raise ValueError(f"{key}: dtype {arr.dtype} has no zarr name here "
                         f"(takes {', '.join(_DTYPES)})")
    return arr, name


def write_orbax_tree(step_dir: str, tree: Mapping) -> None:
    """Write `tree` (nested dicts / lists / tuples of numpy arrays, torch
    tensors, numbers or None; int dict keys are sequence indices) as an orbax
    step directory, under a temporary name and then renamed; an existing
    `step_dir` is replaced. Its `_sharding` file places every array on
    SHARDING_DEVICE, as orbax records an array that lived on one device: a
    restore that gives no shardings of its own (the JAX package's load_fm
    restores into jax.eval_shape's shapes) puts the arrays there."""
    entries: Dict[bytes, Any] = {}  # key -> bytes (inline) or a numpy array (indirect)
    tree_md, sharding = {}, {}
    for keys, leaf in _flatten(tree):
        if not keys:
            raise ValueError("write_orbax_tree takes a tree, not a bare leaf")
        names = tuple(k for k, _ in keys)
        md = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys]}
        if leaf is None:
            md["value_metadata"] = {"value_type": "None", "skip_deserialize": True}
        else:
            arr, dtype = _zarr_array(leaf, ".".join(names))
            shape = list(arr.shape)
            if 0 in shape:
                raise ValueError(f"{'.'.join(names)}: an empty array {shape}")
            path = ".".join(names)
            zarray = {"chunks": shape, "compressor": None, "dimension_separator": ".",
                      "dtype": dtype, "fill_value": None, "filters": None, "order": "C",
                      "shape": shape, "zarr_format": 2}
            entries[f"{path}/.zarray".encode()] = json.dumps(zarray, separators=(",", ":"),
                                                             sort_keys=True).encode()
            entries[f"{path}/{'.'.join('0' * arr.ndim) or '0'}".encode()] = arr
            md["value_metadata"] = {"value_type": "jax.Array", "skip_deserialize": False,
                                    "write_shape": shape}
            sharding[base64.b64encode(path.encode()).decode()] = json.dumps(
                {"sharding_type": "SingleDeviceSharding", "device_str": SHARDING_DEVICE})
        tree_md[str(names)] = md
    parent, base = os.path.split(os.path.abspath(step_dir))
    tmp = os.path.join(parent, f".{base}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "d"))
    data_name = f"d/{uuid.uuid4().hex}"
    keys = sorted(entries)
    refs, n_indirect_bytes = [], 0
    with open(os.path.join(tmp, data_name), "wb") as f:
        for k in keys:  # the indirect values first, then the node
            v = entries[k]
            if isinstance(v, np.ndarray) and v.nbytes > MAX_INLINE_VALUE_BYTES:
                refs.append((k, f.tell(), v.nbytes))
                f.write(memoryview(v.reshape(-1).view(np.uint8)))
                n_indirect_bytes += v.nbytes
        node = _leaf_node(keys, entries, {k: (o, n) for k, o, n in refs}, data_name)
        node_off = f.tell()
        f.write(node)
    now = time.time_ns()
    manifest = _manifest(data_name if keys else "", node_off if keys else _NO_ROOT,
                         len(node) if keys else _NO_ROOT, len(keys), len(node) if keys else 0,
                         n_indirect_bytes, now)
    with open(os.path.join(tmp, "manifest.ocdbt"), "wb") as f:
        f.write(manifest)
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_md, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_sharding"), "w") as f:
        json.dump(sharding, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                   "standard_checkpoint_handler.StandardCheckpointHandler",
                   "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": now,
                   "commit_timestamp_nsecs": now, "custom_metadata": {}}, f)
    if os.path.isdir(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp, step_dir)


def _leaf_node(keys: List[bytes], entries, refs, data_name: str) -> bytes:
    n = len(keys)
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    suffixes = [k[prefix[i - 1] if i else 0:] for i, k in enumerate(keys)]
    lens, kinds, inline = [], [], []
    for k in keys:
        if k in refs:
            lens.append(refs[k][1])
            kinds.append(1)
        else:
            v = entries[k]
            raw = v.tobytes() if isinstance(v, np.ndarray) else v
            lens.append(len(raw))
            kinds.append(0)
            inline.append(raw)
    indirect = [k for k in keys if k in refs]
    body = (bytes([0]) + _files_table([data_name] if indirect else []) + _varint(n)
            + _varints(prefix) + _varints(len(s) for s in suffixes) + b"".join(suffixes)
            + _varints(lens) + _varints(kinds) + _varints(0 for _ in indirect)
            + _varints(refs[k][0] for k in indirect) + b"".join(inline))
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"a b-tree leaf of {len(body)} bytes, above the "
                         f"{MAX_DECODED_NODE_BYTES} one node may hold")
    return _frame(body, NODE_MAGIC)


def _manifest(file: str, off: int, length: int, n_keys: int, tree_bytes: int,
              indirect_bytes: int, commit_ns: int) -> bytes:
    body = (uuid.uuid4().bytes + _varint(0)  # a single manifest
            + _varint(MAX_INLINE_VALUE_BYTES) + _varint(MAX_DECODED_NODE_BYTES)
            + bytes([4]) + _varint(0)  # version tree arity log2; no compression
            + _files_table([file]) + _varint(1)  # one version
            + _varint(1) + bytes([0]) + _varint(0) + _varint(off) + _varint(length)
            + _varint(n_keys) + _varint(tree_bytes) + _varint(indirect_bytes)
            + commit_ns.to_bytes(8, "little") + _varint(0))  # no version tree nodes
    return _frame(body, MANIFEST_MAGIC)
