"""The port's transfer-learning data path (fourm_torch/data/transfer.py,
masking.TransferMasking, utils/remote.py) against the JAX package's on the
CPU: TransferMasking's arrays equal JAX's on the same seed and WordPiece
tokenizer, draw for draw (image and sequence modalities, as inputs and as
targets); the wrappers' indices equal JAX's (a RandomState permutation, a
repeat); build_fm_transfer_dataset over a folder of JPEG and PNG images,
token npy and crop settings written here gives JAX's samples pixel for
pixel (JAX reads the images with Pillow, the port with its own decoders);
a tar shard served by a local http.server thread streams into the same
samples as its local path; s3 raises ImportError naming boto3; and
utils/profiling.py seeds and hashes as the JAX package's."""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import http.server
import io
import random
import sys
import tarfile
import threading
from functools import partial

import numpy as np
import pytest

from fourm_tpu.data import augmenters as jaug
from fourm_tpu.data import masking as jm
from fourm_tpu.data import transfer as jtr
from fourm_tpu.data import transforms as jt
from fourm_tpu.data.modality_info import MODALITY_INFO as JMI
from fourm_tpu.utils import profiling as jprof
from fourm_tpu.utils.text_tokenizer import (generate_coord_tokens, generate_object_class_tokens,
                                            generate_sentinel_tokens,
                                            train_unified_wordpiece_tokenizer)
from fourm_torch.data import augmenters as taug
from fourm_torch.data import datasets as tds
from fourm_torch.data import masking as tm
from fourm_torch.data import transfer as ttr
from fourm_torch.data import transforms as tt
from fourm_torch.data.image_io import write_png
from fourm_torch.data.modality_info import MODALITY_INFO as TMI
from fourm_torch.utils import profiling as tprof
from fourm_torch.utils import remote
from fourm_torch.utils.text_tokenizer import load_tokenizer

Image = pytest.importorskip("PIL.Image")
SEED = 11
WORDS = "a the of on and near photo cat dog grass bicycle house person car red".split()
MODS = ("rgb@224", "tok_depth@224", "crop_settings")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A WordPiece tokenizer, and a transfer folder root/{rgb, tok_depth,
    crop_settings}/{class}/{id}: JPEG (4:2:0, 4:4:4, progressive, grey) and
    PNG images of 230-300 px, 196-token grids and crop settings for 3 crops."""
    d = tmp_path_factory.mktemp("transfer")
    (d / "corpus.txt").write_text((" ".join(WORDS) + "\n") * 40)
    jtok = train_unified_wordpiece_tokenizer(
        str(d / "corpus.txt"), vocab_size=300, sentinel_tokens=generate_sentinel_tokens(num=100),
        coord_tokens=generate_coord_tokens(bins=1000),
        object_class_tokens=generate_object_class_tokens(), show_progress=False)
    jtok.save(str(d / "tokenizer.json"))
    rng = np.random.default_rng(SEED)
    root = d / "folder"
    saves = [dict(quality=90, subsampling=2), dict(quality=95, subsampling=0),
             dict(quality=75, progressive=True), "png", dict(quality=85), "grey"]
    for i, how in enumerate(saves):
        cls = f"class_{i % 2}"
        h, w = (int(v) for v in rng.integers(230, 300, 2))
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([127 + 90 * np.sin(xx / (7 + 3 * c) + yy / (9 + c)) for c in range(3)], -1)
        img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)
        for sub in ("rgb", "tok_depth", "crop_settings"):
            (root / sub / cls).mkdir(parents=True, exist_ok=True)
        base = root / "rgb" / cls / f"{i:04d}"
        if how == "png":
            (base.parent / (base.name + ".png")).write_bytes(write_png(img))
        elif how == "grey":
            Image.fromarray(img[..., 0]).save(str(base) + ".jpg", quality=80)
        else:
            Image.fromarray(img).save(str(base) + ".jpg", **how)
        np.save(root / "tok_depth" / cls / f"{i:04d}.npy", rng.integers(0, 8192, (3, 196)))
        crops = [(int(rng.integers(0, 20)), int(rng.integers(0, 20)), int(rng.integers(150, 200)),
                  int(rng.integers(150, 200)), int(rng.integers(0, 2))) for _ in range(3)]
        np.save(root / "crop_settings" / cls / f"{i:04d}.npy", np.asarray(crops))
    return dict(jtok=jtok, ttok=load_tokenizer(str(d / "tokenizer.json")), root=str(root))


def _assert_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for mod in ref:
        if isinstance(ref[mod], dict):
            _assert_equal(got[mod], ref[mod])
            continue
        a, b = np.asarray(got[mod]), np.asarray(ref[mod])
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b), mod


@pytest.mark.parametrize("split", ["caption_in", "caption_out"])
def test_transfer_masking_equals_jax(data, split):
    mods = ["rgb@224", "caption", "tok_depth@224", "det"]
    inputs = ["rgb@224", "caption"] if split == "caption_in" else ["rgb@224", "det"]
    targets = [m for m in mods if m not in inputs]
    jmask = jm.TransferMasking({m: JMI[m] for m in mods}, data["jtok"], inputs, targets, seed=3)
    tmask = tm.TransferMasking({m: TMI[m] for m in mods}, data["ttok"], inputs, targets, seed=3)
    rng = np.random.default_rng(0)
    for _ in range(4):
        words = " ".join(rng.choice(WORDS, int(rng.integers(3, 30))))
        sample = {"rgb@224": rng.standard_normal((224, 224, 3)).astype(np.float32),
                  "caption": words, "tok_depth@224": rng.integers(0, 8192, 196),
                  "det": f"xmin=10 ymin=20 xmax=30 ymax=40 {words}"}
        _assert_equal(tmask(sample), jmask(sample))
    assert tmask.rng.random() == jmask.rng.random()  # the streams are at the same draw


def test_wrappers_indices_equal_jax():
    base = list(range(17))
    for size, seed in ((5, 0), (None, 3), (40, 7)):
        a = ttr.SubsampleDatasetWrapper(base, size, seed, return_orig_idx=True)
        b = jtr.SubsampleDatasetWrapper(base, size, seed, return_orig_idx=True)
        assert len(a) == len(b) and [a[i] for i in range(len(a))] == [b[i] for i in range(len(b))]
    r, jr = ttr.RepeatedDatasetWrapper(base, 3), jtr.RepeatedDatasetWrapper(base, 3)
    assert len(r) == len(jr) == 51 and [r[i] for i in range(51)] == [jr[i] for i in range(51)]
    assert ttr.convert_samples_to_mod_dict((1, 2), "a", "b") == \
        jtr.convert_samples_to_mod_dict((1, 2), "a", "b")


def _jax_dataset(data):
    jmt = {"rgb": jt.RGBTransform(imagenet_default_mean_and_std=True),
           "tok_depth": jt.TokTransform()}
    unified = jt.UnifiedDataTransform(
        jmt, jaug.PreTokenizedImageAugmenter(224, main_domain="rgb@224"))
    mask = jm.TransferMasking({m: JMI[m] for m in MODS[:2]}, data["jtok"], ["rgb@224"],
                              ["tok_depth@224"], seed=SEED)
    return jtr.build_fm_transfer_dataset(data["root"], JMI, lambda s: mask(unified(s)), jmt,
                                         MODS)


def _port_dataset(data):
    rngs = dict(rng=random.Random(SEED), np_rng=np.random.RandomState(SEED))
    pmt = {"rgb": tt.RGBTransform(imagenet_default_mean_and_std=True, **rngs),
           "tok_depth": tt.TokTransform(**rngs)}
    unified = tt.UnifiedDataTransform(
        pmt, taug.PreTokenizedImageAugmenter(224, main_domain="rgb@224", **rngs))
    mask = tm.TransferMasking({m: TMI[m] for m in MODS[:2]}, data["ttok"], ["rgb@224"],
                              ["tok_depth@224"], seed=SEED)
    return ttr.build_fm_transfer_dataset(data["root"], lambda s: mask(unified(s)), pmt, MODS)


def test_transfer_dataset_equals_jax(data):
    """Every sample of the folder (JPEG of four kinds, PNG, grey JPEG) through
    the crop of its persisted settings, the resize, the flip and
    TransferMasking: JAX's arrays, pixel for pixel; the wrappers over it
    return the same samples in the same order."""
    random.seed(SEED)
    np.random.seed(SEED)
    jds = jtr.RepeatedDatasetWrapper(_jax_dataset(data), 2)
    tds_ = ttr.RepeatedDatasetWrapper(_port_dataset(data), 2)
    assert len(tds_) == len(jds) == 12
    for i in range(len(jds)):
        got, ref = tds_[i], jds[i]
        _assert_equal(got, ref)
        assert got["rgb@224"]["tensor"].shape == (224, 224, 3)
        assert not got["rgb@224"]["input_mask"].any() and got["tok_depth@224"]["input_mask"].all()


def test_transfer_loader_batches_the_folder(data):
    """build_transfer_loader inline: one pass of B = 2 batches, each the
    stacked samples of folder_transfer_dataset (seeded by worker_seed) in a
    RandomState(seed) order; the sequence-free split needs no tokenizer."""
    split = (["rgb@224"], ["tok_depth@224"])
    batches = list(ttr.build_transfer_loader(data["root"], *split, batch_size=5, num_workers=0,
                                             seed=4, num_repeats=2))
    ds = ttr.folder_transfer_dataset(data["root"], *split, seed=tprof.worker_seed(4, 0),
                                     num_repeats=2)
    order = np.random.RandomState(4).permutation(12)
    assert len(batches) == 2
    for b, batch in enumerate(batches):
        want = tds.batch_mod_dicts([ds[int(i)] for i in order[5 * b:5 * b + 5]])
        _assert_equal(batch, want)
        assert batch["rgb@224"]["tensor"].shape == (5, 224, 224, 3)
        assert batch["tok_depth@224"]["tensor"].shape == (5, 196)


def _shard(samples):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for key, members in samples:
            for ext, payload in members.items():
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    return buf.getvalue()


def test_http_shard_equals_local_and_s3_raises(data, tmp_path, monkeypatch):
    files = sorted((p for p in __import__("pathlib").Path(data["root"]).rglob("*")
                    if p.suffix in (".jpg", ".png")), key=str)
    samples = [(f"{i:06d}", {"rgb" + p.suffix: p.read_bytes(),
                             "caption.txt": f"a photo {i}".encode()})
               for i, p in enumerate(files)]
    (tmp_path / "shard-000.tar").write_bytes(_shard(samples))
    handler = partial(http.server.SimpleHTTPRequestHandler, directory=str(tmp_path))
    handler.log_message = lambda *a, **k: None
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/shard-000.tar"
        assert remote.is_remote(url) and not remote.is_remote(str(tmp_path))
        local = list(tds.iterate_multi_tar_samples([str(tmp_path / "shard-000.tar")]))
        served = list(tds.iterate_multi_tar_samples([url]))
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    assert len(served) == len(local) == len(files)
    for a, b in zip(served, local):
        assert a.pop("__url__") == url and b.pop("__url__").endswith("shard-000.tar")
        assert a == b
        ref = tds.decode_sample(b, ["rgb"], {})
        assert np.array_equal(tds.decode_sample(a, ["rgb"], {})["rgb"], ref["rgb"])
    monkeypatch.setitem(sys.modules, "boto3", None)  # absent, whatever another test stubbed
    with pytest.raises(ImportError, match="boto3"):
        list(tds.iterate_multi_tar_samples(["s3://bucket/shard-0000.tar"]))
    with pytest.raises(ImportError, match="boto3"):
        remote.open_url("s3://bucket/key.tar")


def test_profiling_seeds_equal_jax(tmp_path):
    for args in ((0, 0), (7, 3, 1), (2**40, 11, 5)):
        assert tprof.worker_seed(*args) == jprof.worker_seed(*args)
    tprof.seed_everything(123)
    a = (random.random(), np.random.rand())
    jprof.seed_everything(123)
    assert (random.random(), np.random.rand()) == a
    times = {}
    with tprof.profile_trace(str(tmp_path)) as prof, tprof.step_timer("step", times):
        sum(range(1000))
    assert prof is not None and (tmp_path / "trace.json").exists() and times["step"] >= 0
    with tprof.profile_trace(None) as prof:
        assert prof is None
