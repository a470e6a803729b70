"""Dataset builders of 4M pre-training, PyTorch port: aligned multi-modal
folder dataset, sharded-tar streaming (webdataset-equivalent), weighted
mixture with empty-modality padding.

The port's own copy of fourm_tpu/data/datasets.py (reference fourm/data/
unified_datasets.py and multimodal_dataset_folder.py), torch- and
webdataset-free:

  * MultiModalDatasetFolder: root/{modality}/{class}/{file.ext} aligned loading
  * iterate_multi_tar_samples: per-modality tar shards merged by sample key, with
    brace expansion and key-alignment checks (reference unified_datasets.py:237-317)
  * ShardedTarDataset: resample shards per worker (the reference's
    "statistical" data parallelism, unified_datasets.py:371-373), shuffle
    buffer, decode, unified transform, masking
  * MixtureDataset: weighted multi-dataset sampling padded with empty modalities
    so every batch has identical structure (unified_datasets.py:487-545)
  * build_fm_pretraining_dataset / batched_loader glue

Tar shards are read by the port's native reader (fourm_torch/native) when
it builds, else by Python's tarfile; each ShardedTarDataset prints which
reader serves it, and `TAR_READS` counts the shards each reader opened in
this process; http(s):// shards stream through tarfile (utils/remote.py),
and s3:// ones need boto3 and raise ImportError without it. Images are
decoded by data/image_io.py (PNG and JPEG, without Pillow). The Hugging
Face text dataset is not ported and raises.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import io
import itertools
import json
import os
import random
import re
import tarfile
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import image_io
from .batching import batch_mod_dicts, make_empty_mod
from .modality_info import MODALITY_INFO, ModalitySpec
from .transforms import get_transform_key

# shards opened in this process, by reader ("native", "tarfile")
TAR_READS: collections.Counter = collections.Counter()


def braceexpand(pattern: str) -> List[str]:
    """Minimal brace expansion: {a,b}, {000..123} (zero-padded ranges)."""
    m = re.search(r"\{([^{}]*)\}", pattern)
    if not m:
        return [pattern]
    body = m.group(1)
    pre, post = pattern[: m.start()], pattern[m.end():]
    rng = re.fullmatch(r"(\d+)\.\.(\d+)", body)
    if rng:
        a, b = rng.group(1), rng.group(2)
        width = len(a)
        options = [str(i).zfill(width) for i in range(int(a), int(b) + 1)]
    else:
        options = body.split(",")
    out = []
    for opt in options:
        out.extend(braceexpand(pre + opt + post))
    return out


# ----------------------------------------------------------- folder datasets

UNIFIED_EXTENSIONS = [".jpg", ".jpeg", ".png", ".json", ".txt", ".json.gz", ".npy", ".npz"]


def _find_files(folder: str) -> Dict[str, str]:
    """Map sample-id (relative path without extension) -> full path."""
    out = {}
    for dirpath, _dirs, files in sorted(os.walk(folder, followlinks=True)):
        for fname in sorted(files):
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, folder)
            sample_id = rel
            for ext in sorted(UNIFIED_EXTENSIONS, key=len, reverse=True):
                if rel.endswith(ext):
                    sample_id = rel[: -len(ext)]
                    break
            out[sample_id] = full
    return out


class MultiModalDatasetFolder:
    """Aligned root/{modality}/{class}/{file.ext} dataset
    (reference multimodal_dataset_folder.py:201-363).

    modality_paths can remap modality -> folder name. Samples present in every
    modality folder are kept, sorted by id.
    """

    def __init__(
        self,
        root: str,
        modalities: Sequence[str],
        modality_transforms: Dict[str, Any],
        transform=None,
        modality_paths: Optional[Dict[str, str]] = None,
        max_samples: Optional[int] = None,
        pre_shuffle: bool = False,
        seed: int = 0,
    ):
        self.root = root
        self.modalities = list(modalities)
        self.modality_transforms = modality_transforms
        self.transform = transform
        self.modality_paths = modality_paths or {}

        per_mod = {}
        for mod in self.modalities:
            folder = os.path.join(root, self.modality_paths.get(mod, get_transform_key(mod)))
            per_mod[mod] = _find_files(folder)
        common = set.intersection(*(set(v.keys()) for v in per_mod.values()))
        ids = sorted(common)
        if pre_shuffle:
            random.Random(seed).shuffle(ids)
        if max_samples is not None:
            ids = ids[:max_samples]
        self.sample_ids = ids
        self.paths = {mod: [per_mod[mod][i] for i in ids] for mod in self.modalities}

    def __len__(self):
        return len(self.sample_ids)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        from .transforms import CropSettingsTransform

        sample = {}
        for mod in self.modalities:
            key = get_transform_key(mod)
            if key == "crop_settings":
                transform = CropSettingsTransform()
            else:
                transform = self.modality_transforms[key]
            sample[mod] = transform.load(self.paths[mod][index])
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


# -------------------------------------------------------------- tar streaming

def _tar_samples(path_or_file) -> Iterator[Dict[str, Any]]:
    """Group tar members by sample key: '000123.ext' or '000123.modality.ext'
    (webdataset convention). Uses the native C++ indexed reader for plain
    uncompressed tar paths (fourm_torch/native), falling back to Python
    tarfile, which also streams http(s):// shards; the reader that opens the
    shard is counted in TAR_READS."""
    from ..utils.remote import is_remote, open_url

    if isinstance(path_or_file, str) and is_remote(path_or_file):
        # http(s):// shards stream through tarfile; s3:// needs boto3 and
        # raises ImportError without it
        with contextlib.closing(open_url(path_or_file)) as stream:
            yield from _tar_samples(stream)
        return
    if isinstance(path_or_file, str) and re.match(r"^[a-z][a-z0-9+.-]*://", path_or_file):
        raise NotImplementedError(f"{path_or_file}: only local, http(s) and s3 shards are read")
    elif isinstance(path_or_file, str) and path_or_file.endswith(".tar"):
        from ..native import native_available, native_tar_samples

        if native_available():
            TAR_READS["native"] += 1
            yield from native_tar_samples(path_or_file)
            return
    TAR_READS["tarfile"] += 1
    tf = tarfile.open(path_or_file, mode="r|*") if isinstance(path_or_file, str) else \
        tarfile.open(fileobj=path_or_file, mode="r|*")
    current_key = None
    current: Dict[str, Any] = {}
    with tf:
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            base = os.path.basename(name)
            key, _, rest = base.partition(".")
            data = tf.extractfile(member).read()
            if current_key is not None and key != current_key:
                yield {"__key__": current_key, **current}
                current = {}
            current_key = key
            current[rest] = data
        if current_key is not None:
            yield {"__key__": current_key, **current}


def _extract_modality_names(url: str) -> List[str]:
    m = re.search(r"\[([^\[\]]*)\]", url)
    return m.group(1).split(",") if m else []


def iterate_multi_tar_samples(
    urls: Iterable[str],
    modality_name_map: Optional[Dict[str, str]] = None,
    on_error: str = "warn",
) -> Iterator[Dict[str, Any]]:
    """Merge per-modality tar shards into aligned samples
    (reference unified_datasets.py:237-317). URL syntax:
    'root_[rgb,caption]/00000.tar' -> root_rgb/00000.tar + root_caption/00000.tar.
    Raises on key divergence between modality shards."""
    for url in urls:
        modality_names = _extract_modality_names(url)
        if not modality_names:
            expanded = [url]
            modality_names = [None]
        else:
            expanded = [re.sub(r"\[[^\[\]]*\]", name, url, count=1) for name in modality_names]
        try:
            iters = [_tar_samples(u) for u in expanded]
            for parts in zip(*iters):
                merged = {"__key__": parts[0]["__key__"], "__url__": url}
                for mod_name, d in zip(modality_names, parts):
                    d = dict(d)
                    key = d.pop("__key__")
                    if key != merged["__key__"]:
                        raise ValueError(
                            f"shard divergence: key {key} of {mod_name} vs {merged['__key__']}"
                        )
                    multimodal = len(d) > 1
                    for k, v in d.items():
                        if multimodal or "." in k or mod_name is None:
                            merged[k] = v
                        else:
                            name = (modality_name_map or {}).get(mod_name, mod_name)
                            merged[f"{name}.{k}"] = v
                yield merged
        except (NotImplementedError, ImportError):  # a missing reader, not a bad shard
            raise
        except Exception as e:  # corrupt shard tolerance (unified_datasets.py:31)
            if on_error == "warn":
                print(f"[data] skipping shard {url}: {e}", flush=True)
                continue
            raise


def decode_sample(raw: Dict[str, Any], modalities: Sequence[str],
                  modality_transforms: Dict[str, Any]) -> Dict[str, Any]:
    """Decode raw tar bytes into modality values: images by data/image_io.py
    (numpy uint8), npy / npz arrays, JSON, text."""
    out = {}
    for mod in modalities:
        tkey = get_transform_key(mod)
        match = None
        for k in raw:
            if k.startswith(f"{tkey}."):
                match = k
                break
        if match is None:
            continue
        data = raw[match]
        ext = match.split(".", 1)[1]
        if ext in ("jpg", "jpeg", "png"):
            out[mod] = image_io.decode_image(data, f"{raw.get('__url__', '?')}:"
                                                   f"{raw.get('__key__', '?')}.{match}")
        elif ext == "npy":
            out[mod] = np.load(io.BytesIO(data), allow_pickle=False)
        elif ext == "npz":
            z = np.load(io.BytesIO(data))
            out[mod] = {k: z[k] for k in z.files}
        elif ext in ("json", "json.gz"):
            payload = data if ext == "json" else gzip.decompress(data)
            out[mod] = json.loads(payload)
        elif ext == "txt":
            out[mod] = data.decode("utf-8")
        else:
            out[mod] = data
    if "crop_settings.npy" in raw:
        out["crop_settings"] = np.load(io.BytesIO(raw["crop_settings.npy"]), allow_pickle=False)
    return out


class ShardedTarDataset:
    """Infinite iterable over sharded tars with per-worker shard resampling and a
    shuffle buffer (reference build_wds_fm_pretraining_dataloader pipeline,
    unified_datasets.py:319-395)."""

    def __init__(
        self,
        shard_pattern: str,
        modalities: Sequence[str],
        modality_transforms: Dict[str, Any],
        transform=None,
        shuffle_buffer: int = 1000,
        resample: bool = True,
        seed: Optional[int] = None,
        modality_name_map: Optional[Dict[str, str]] = None,
        n_repeats: int = 1,
        shuffle_buffer_repeat: int = 1000,
        shard_split: Optional[Tuple[int, int]] = None,
    ):
        self.pattern = shard_pattern
        self.urls = braceexpand(shard_pattern)
        if shard_split is not None:  # reader i of n (ranks x workers) reads its own shards
            i, n = shard_split
            if len(self.urls) < n:
                raise ValueError(f"{shard_pattern}: {len(self.urls)} shards cannot give each "
                                 f"of {n} readers (ranks x workers) shards of its own")
            self.urls = self.urls[i::n]
        self.modalities = list(modalities)
        self.modality_transforms = modality_transforms
        self.transform = transform
        self.shuffle_buffer = shuffle_buffer
        self.resample = resample
        self.rng = random.Random(seed)
        self.modality_name_map = modality_name_map
        # reference wds_n_repeats: emit each decoded sample n times (each
        # repeat gets an independent mask/augment draw downstream) through a
        # second shuffle buffer — amortizes tar decode cost
        # (unified_datasets.py:376-381)
        self.n_repeats = n_repeats
        self.shuffle_buffer_repeat = shuffle_buffer_repeat

    def _shard_iter(self):
        if self.resample:
            while True:
                yield self.rng.choice(self.urls)
        else:
            yield from self.urls

    def _decoded_iter(self):
        raw_iter = iterate_multi_tar_samples(self._shard_iter(), self.modality_name_map)
        buf: List[Dict] = []
        announced = False
        for raw in raw_iter:
            if not announced:
                print(f"[data] {self.pattern}: shards read by the "
                      f"{'native tar reader' if TAR_READS['native'] else 'tarfile'}", flush=True)
                announced = True
            sample = decode_sample(raw, self.modalities, self.modality_transforms)
            if not sample:
                continue
            if self.shuffle_buffer > 1:
                buf.append(sample)
                if len(buf) < self.shuffle_buffer:
                    continue
                idx = self.rng.randrange(len(buf))
                sample, buf[idx] = buf[idx], sample
                buf.pop()
            yield sample

    def __iter__(self):
        it = self._decoded_iter()
        if self.n_repeats > 1:
            base = it

            def repeated():
                rbuf: List[Dict] = []
                for sample in base:
                    for _ in range(self.n_repeats):
                        if self.shuffle_buffer_repeat > 1:
                            rbuf.append(sample)
                            if len(rbuf) < self.shuffle_buffer_repeat:
                                continue
                            i = self.rng.randrange(len(rbuf))
                            out, rbuf[i] = rbuf[i], sample
                            rbuf.pop()
                            yield out
                        else:
                            yield sample
                yield from rbuf

            it = repeated()
        for sample in it:
            if self.transform is not None:
                sample = self.transform(dict(sample))
            yield sample


# ------------------------------------------------------------------- mixture

class MixtureDataset:
    """Weighted sampling from multiple infinite iterables; missing modalities are
    padded with fully-masked placeholders (reference unified_datasets.py:524-545)."""

    def __init__(self, data_iters: List[Iterable], weights: Sequence[float],
                 modality_info: Dict[str, ModalitySpec], seed: Optional[int] = None):
        self.orig = list(data_iters)
        self.iters = [iter(d) for d in data_iters]
        self.probs = np.asarray(weights, dtype=np.float64) / np.sum(weights)
        self.modality_info = modality_info
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        while True:
            i = int(self.rng.choice(len(self.probs), p=self.probs))
            try:
                data = next(self.iters[i])
            except StopIteration:
                self.iters[i] = iter(self.orig[i])
                data = next(self.iters[i])
            mod_dict = {name: make_empty_mod(spec) for name, spec in self.modality_info.items()}
            mod_dict.update(data)
            yield mod_dict


# ----------------------------------------------------------------- loaders

def repeat_dataset(dataset, np_rng: Optional[np.random.RandomState] = None) -> Iterator:
    """Infinite repetition of a map-style dataset with reshuffling, the
    orders drawn from `np_rng` (the JAX package draws from np.random)."""
    n = len(dataset)
    np_rng = np_rng if np_rng is not None else np.random.RandomState()
    while True:
        order = np_rng.permutation(n)
        for i in order:
            yield dataset[int(i)]


def batched_loader(iterable: Iterable[Dict], batch_size: int,
                   epoch_size: Optional[int] = None) -> Iterator[Dict]:
    """Collate an infinite sample iterator into batched numpy mod dicts.

    epoch_size bounds the number of *samples* per epoch (reference with_epoch)."""
    it = iter(itertools.islice(iterable, epoch_size) if epoch_size else iterable)
    while True:
        batch = list(itertools.islice(it, batch_size))
        if len(batch) < batch_size:
            return
        yield batch_mod_dicts(batch)


def build_fm_pretraining_dataset(
    data_path: str,
    all_domains: Sequence[str],
    modality_transforms: Dict[str, Any],
    image_augmenter,
    masking,
    modality_paths: Optional[Dict[str, str]] = None,
    max_samples: Optional[int] = None,
) -> MultiModalDatasetFolder:
    """Folder-based pretraining dataset: load -> unified transform -> masking
    (reference unified_datasets.py:48-90)."""
    from .transforms import UnifiedDataTransform

    unified = UnifiedDataTransform(modality_transforms, image_augmenter)

    def transform(sample):
        return masking(unified(sample))

    # modality paths default from the registry (e.g. rgb@224 -> rgb)
    paths = dict(modality_paths or {})
    for mod in all_domains:
        spec = MODALITY_INFO.get(mod)
        if spec is not None and spec.path and mod not in paths:
            paths[mod] = spec.path
    return MultiModalDatasetFolder(
        data_path, list(all_domains), modality_transforms, transform=transform,
        modality_paths=paths, max_samples=max_samples,
    )


def build_huggingface_text_dataset(*args, **kwargs):
    """Text-only pretraining from Hugging Face datasets (fourm_tpu/data/
    datasets.py:425): not ported yet, it needs the `datasets` package and the
    network."""
    raise NotImplementedError("build_huggingface_text_dataset is not ported: it needs the "
                              "`datasets` package (and the network), which the port does not "
                              "use")


def prefetch_iterator(iterable: Iterable, prefetch: int = 2):
    """Run an iterator in a background thread with a bounded queue, which
    overlaps host-side data work (decode, masking) with device steps. An
    exception of the iterator is raised to the consumer (the JAX package's
    ends the stream quietly); closing this generator stops the thread and
    closes the iterator (its worker processes with it)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        it = iter(iterable)
        try:
            for item in it:
                if not put(item):
                    break
        except BaseException as e:  # handed to the consumer
            put((done, e))
            return
        finally:
            close = getattr(it, "close", None)
            if stop.is_set() and close is not None:
                close()
        put((done, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is done:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=30)


class ParallelMapDataset:
    """Multi-process map over a map-style dataset (the transform runs in
    forked workers, which touch no CUDA), for the Dirichlet / span-masking
    host work."""

    def __init__(self, dataset, num_workers: int = 4):
        self.dataset = dataset
        self.num_workers = num_workers

    def __len__(self):
        return len(self.dataset)

    def iter_shuffled(self, seed: int = 0):
        import multiprocessing as mp

        if self.num_workers <= 0:
            yield from repeat_dataset(self.dataset)
            return
        ctx = mp.get_context("fork")
        with ctx.Pool(self.num_workers) as pool:
            epoch = 0
            while True:
                order = np.random.default_rng(seed + epoch).permutation(len(self.dataset))
                for sample in pool.imap(self.dataset.__getitem__, order.tolist(),
                                        chunksize=4):
                    yield sample
                epoch += 1
