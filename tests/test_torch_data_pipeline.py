"""The port's data pipeline (fourm_torch/data) against the JAX package's
(fourm_tpu/data) on the same files and seeds, on the CPU.

The 4M-21 modality set of cfgs/default/4m/models/main/4m-b_mod21_500b.yaml
with its alphas mixture, on synthetic samples written by fourm_torch/utils/
synthetic_shards.py: tar shards in the `[a,b]` layout and an aligned
folder. The JAX transforms draw from the global `random` / `np.random`; the
port from one `random.Random(seed)` / `np.random.RandomState(seed)` pair
per dataset; seeding the JAX globals with the same seed, the batches are
equal with np.array_equal, key for key. `sam_instance` runs on the JAX
side through a cv2 stub whose point-in-polygon test is written here
(ray casting with an explicit boundary check), independent of the port's
`point_in_polygon`, which is held to hand-made cases and, where cv2 is
installed, to cv2.pointPolygonTest itself. Also: the alphas files read by
the port's YAML reader equal PyYAML's, the native tar reader equals
tarfile, the loader's workers interleave in a fixed order and surface an
error, and the port's modules import none of the libraries the card's
machine lacks.
"""

import glob
import itertools
import os
import random
import sys
import tarfile
import types

import numpy as np
import pytest
import torch
import yaml

from fourm_tpu.data import datasets as jds
from fourm_tpu.data import pretrain_utils as jpu
from fourm_tpu.utils.text_tokenizer import (generate_coord_tokens, generate_object_class_tokens,
                                            generate_sentinel_tokens,
                                            train_unified_wordpiece_tokenizer)
from fourm_torch.data import datasets as tds
from fourm_torch.data import pretrain_utils as tpu
from fourm_torch.data.transforms import point_in_polygon
from fourm_torch.utils import synthetic_shards as ss
from fourm_torch.utils.config import load_yaml
from fourm_torch.utils.text_tokenizer import load_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_CFG = os.path.join(REPO, "cfgs/default/4m/models/main/4m-b_mod21_500b.yaml")
ALPHAS = os.path.join(REPO, "cfgs/default/4m/alphas_mixture/main/"
                            "mix_mod21_all2allmix_rgb2all_capT5bias.yaml")
WORDS = "a the of on and near photo cat dog grass bicycle house person car red blue".split()
SEED = 7


def _domains():
    cfg = load_yaml(MODEL_CFG)
    return cfg["in_domains"].split("-"), cfg["out_domains"].split("-")


def _stub_point_polygon_test(contour, pt, measureDist):  # noqa: N803 (cv2's name)
    """cv2.pointPolygonTest's sign with measureDist: +1 inside, 0 on the
    boundary, -1 outside (even-odd ray casting to the right)."""
    pts = [tuple(int(v) for v in p) for p in np.asarray(contour).reshape(-1, 2)]
    x, y = pt
    inside = False
    for (x0, y0), (x1, y1) in zip(pts, pts[1:] + pts[:1]):
        if min(x0, x1) <= x <= max(x0, x1) and min(y0, y1) <= y <= max(y0, y1) and (
                (x1 - x0) * (y - y0) == (y1 - y0) * (x - x0)):
            return 0.0
        if (y0 > y) != (y1 > y) and x < x0 + (y - y0) * (x1 - x0) / (y1 - y0):
            inside = not inside
    return 1.0 if inside else -1.0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pretrain_data")
    (d / "corpus.txt").write_text((" ".join(WORDS) + " human pose shape global camera point "
                                   "polygon none\n") * 50)
    tok = train_unified_wordpiece_tokenizer(
        str(d / "corpus.txt"), vocab_size=400, sentinel_tokens=generate_sentinel_tokens(num=100),
        coord_tokens=generate_coord_tokens(bins=1000),
        object_class_tokens=generate_object_class_tokens(), show_progress=False)
    tok_path = str(d / "tokenizer.json")
    tok.save(tok_path)
    din, dout = _domains()
    doms = sorted(set(din) | set(dout))
    kw = dict(image_size=(232, 260), t5_len=12)
    pattern = ss.write_shards(str(d / "shards"), doms, 2, 3, SEED, WORDS, **kw)
    folder = ss.write_folder(str(d / "folder"), doms, 4, SEED + 1, WORDS, **kw)
    return dict(tok=tok, tok_path=tok_path, pattern=pattern, folder=folder, din=din, dout=dout)


@pytest.fixture
def cv2_stub(monkeypatch):
    stub = types.ModuleType("cv2")
    stub.pointPolygonTest = _stub_point_polygon_test
    monkeypatch.setitem(sys.modules, "cv2", stub)


def _dataset_config(files, use_wds, **extra):
    path = files["pattern"] if use_wds else files["folder"]
    cfg = ss.data_config(path, files["din"], files["dout"], ALPHAS, use_wds=use_wds,
                         shuffle_buffer=4)["train"]["datasets"]["synthetic"]
    return {**cfg, **extra}


def _assert_batches_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for mod in ref:
        assert sorted(got[mod]) == sorted(ref[mod]), mod
        for k in ref[mod]:
            a, b = np.asarray(got[mod][k]), np.asarray(ref[mod][k])
            assert a.shape == b.shape and a.dtype == b.dtype, (mod, k, a.shape, b.shape)
            assert np.array_equal(a, b), (mod, k)


@pytest.mark.parametrize("use_wds", [True, False], ids=["tar", "folder"])
@pytest.mark.parametrize("min_tokens", [None, (64, 32)], ids=["fixed", "min_tokens"])
def test_batches_equal_jax(files, cv2_stub, use_wds, min_tokens):
    """get_train_dataset + build_mixture_loader: two batches of 3 from the
    4M-21 shards (or folder), 256 + 256 tokens, equal to JAX's."""
    cfg = _dataset_config(files, use_wds)
    mi, mt = min_tokens or (None, None)
    args = (224, 256, 256, mi, mt)
    all_domains = sorted(set(files["din"]) | set(files["dout"]))
    random.seed(SEED)
    np.random.seed(SEED)
    jset = jpu.get_train_dataset(cfg, files["tok"], *args, seed=SEED)
    ref = list(itertools.islice(jpu.build_mixture_loader([jset], [1.0], all_domains, 3,
                                                         seed=SEED), 2))
    reads = dict(tds.TAR_READS)
    tset = tpu.get_train_dataset(cfg, load_tokenizer(files["tok_path"]), *args, seed=SEED)
    got = list(itertools.islice(tpu.build_mixture_loader([tset], [1.0], all_domains, 3,
                                                         seed=SEED), 2))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _assert_batches_equal(g, r)
    opened = {k: tds.TAR_READS[k] - reads.get(k, 0) for k in ("native", "tarfile")}
    assert (opened["native"] > 0 and not opened["tarfile"]) if use_wds else not any(
        opened.values())


def test_val_and_reader_paths(files, cv2_stub, monkeypatch):
    """get_val_dataset (fixed 128 + 128 budgets, no augmentation) over the
    folder equals JAX's; the native tar reader equals tarfile member for
    member; an s3 shard (no boto3) and the Hugging Face dataset raise."""
    cfg = _dataset_config(files, False)
    random.seed(SEED)
    np.random.seed(SEED)
    jval = jpu.get_val_dataset(cfg, files["tok"], 224, 256, 256, seed=SEED)
    tval = tpu.get_val_dataset(cfg, load_tokenizer(files["tok_path"]), 224, 256, 256, seed=SEED)
    ref = list(jds.batched_loader(iter(jval), 2))
    got = list(tds.batched_loader(iter(tval), 2))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _assert_batches_equal(g, r)
        assert int((~g["tok_rgb@224"]["input_mask"]).sum()) <= 2 * 128

    shard = tds.braceexpand(files["pattern"].replace("[rgb,tok,text,t5]", "text"))[0]
    native = list(tds._tar_samples(shard))
    with tarfile.open(shard) as tf:
        names = [m.name for m in tf.getmembers()]
        members = {m.name: tf.extractfile(m).read() for m in tf.getmembers()}
    assert sum(len(s) - 1 for s in native) == len(names)
    for s in native:
        for k, v in s.items():
            if k != "__key__":
                assert members[f"{s['__key__']}.{k}"] == v
    monkeypatch.setitem(sys.modules, "boto3", None)  # absent, whatever another test stubbed
    with pytest.raises(ImportError, match="boto3"):  # http(s) streams (test_torch_transfer)
        next(tds._tar_samples("s3://bucket/shard-0000.tar"))
    with pytest.raises(NotImplementedError, match="datasets"):
        tds.build_huggingface_text_dataset("c4")


def test_shard_divergence_and_repeats(files, tmp_path):
    """The `[a,b]` syntax merges by key and refuses shards whose keys
    diverge (a warning and the shard skipped, as JAX; raised on request);
    n_repeats emits each sample n times."""
    root = tmp_path / "bad"
    for g, keys in (("a", ["000", "001"]), ("b", ["000", "002"])):
        (root / g).mkdir(parents=True)
        with tarfile.open(root / g / "s.tar", "w") as tf:
            for k in keys:
                ss._add(tf, f"{k}.{g}.txt", k.encode())
    url = str(root / "[a,b]" / "s.tar")
    assert len(list(tds.iterate_multi_tar_samples([url]))) == 1
    with pytest.raises(ValueError, match="divergence"):
        list(tds.iterate_multi_tar_samples([url], on_error="raise"))
    assert [s["__key__"] for s in jds.iterate_multi_tar_samples([url])] == ["000"]
    ds = tds.ShardedTarDataset(str(root / "a" / "s.tar"), ["a"], {}, shuffle_buffer=1,
                               resample=False, n_repeats=3, shuffle_buffer_repeat=1)
    assert [s["a"] for s in ds] == ["000"] * 3 + ["001"] * 3


def test_point_in_polygon():
    """Vertices and edges count as inside (cv2's `>= 0`), a concave
    polygon's notch is outside, and (where cv2 is installed) random points
    agree with cv2.pointPolygonTest(..., True) >= 0."""
    square = [[[0, 0]], [[10, 0]], [[10, 10]], [[0, 10]]]
    for p, want in [((5, 5), True), ((0, 0), True), ((10, 5), True), ((5, 10), True),
                    ((11, 5), False), ((-1, -1), False), ((10, 11), False)]:
        assert point_in_polygon(square, p) == want, p
    notch = [[[0, 0]], [[10, 0]], [[10, 10]], [[5, 3]], [[0, 10]]]  # concave at (5, 3)
    for p, want in [((5, 2), True), ((5, 3), True), ((5, 6), False), ((2, 5), True),
                    ((9, 8), True), ((8, 8), False), ((5, 9), False)]:
        assert point_in_polygon(notch, p) == want, p
        assert (_stub_point_polygon_test(notch, p, True) >= 0) == want, p
    rng = np.random.default_rng(3)
    polys = [ss._contour(rng, 224) for _ in range(20)] + [square, notch]
    pts = [tuple(int(v) for v in rng.integers(0, 224, 2)) for _ in range(200)]
    for poly in polys:
        for p in pts + [tuple(v[0]) for v in poly]:
            assert point_in_polygon(poly, p) == (_stub_point_polygon_test(poly, p, True) >= 0)
    try:
        import cv2
    except ImportError:
        return
    for poly in polys:
        c = np.asarray(poly, np.int32)
        for p in pts + [tuple(v[0]) for v in poly]:
            assert point_in_polygon(poly, p) == (cv2.pointPolygonTest(c, p, True) >= 0), (poly, p)


ALPHA_FILES = sorted(glob.glob(os.path.join(REPO, "cfgs/default/4m/alphas_mixture/**/*.yaml"),
                               recursive=True)
                     + glob.glob(os.path.join(REPO, "cfgs/default/4m/data/**/*.yaml"),
                                 recursive=True))


@pytest.mark.parametrize("path", ALPHA_FILES, ids=[os.path.relpath(p, REPO) for p in ALPHA_FILES])
def test_alphas_and_data_configs_read_as_pyyaml(path):
    with open(path) as f:
        assert load_yaml(path) == yaml.safe_load(f)


def test_sampling_mod_info_matches_jax(files):
    cfg = _dataset_config(files, True)
    assert tpu.setup_sampling_mod_info(cfg) == jpu.setup_sampling_mod_info(cfg)


def test_multiprocess_loader_order_and_errors():
    """Two spawn workers interleave in turn (0, 1, 0, 1, ...) until worker 1
    fails, whose exception then reaches the consumer with its type and
    message; each item's arrays arrive as tensors equal to the worker's
    (dtype, shape and values; a reversed view included) and its other
    values as they were; inline mode runs the factory once."""
    from fourm_torch.data.loader import MultiprocessLoader
    from loader_factories import two_workers_one_fails

    items = []
    with pytest.raises(ValueError, match="boom"):
        for item in MultiprocessLoader(two_workers_one_fails, num_workers=2):
            items.append((item["worker"], item["i"]))
            ref = next(itertools.islice(two_workers_one_fails(item["worker"], 2), item["i"],
                                        None))["arrays"]
            got = item["arrays"]
            assert got["name"] == ref["name"]
            for k in ("a", "m"):
                assert isinstance(got[k], torch.Tensor)
                assert got[k].numpy().dtype == ref[k].dtype and np.array_equal(got[k], ref[k])
    assert items == [(0, 0), (1, 0), (0, 1), (1, 1), (0, 2)]
    assert len(list(MultiprocessLoader(two_workers_one_fails, num_workers=0))) == 3
