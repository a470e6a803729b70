"""The port's two examples (examples/end_to_end_demo_torch.py,
examples/retrieval_demo_torch.py), each `main` run once on the CPU in bf16
(their default dtype) with the cuts the test needs: one train step over two
images and two ROAR steps for the end-to-end demo, a gallery of two for the
retrieval demo. The end-to-end demo's text tokenizer equals, in size, what
the JAX package trains on the same corpus; its stages run in order; every
output is finite and of the JAX demo's shape."""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import importlib.util
from pathlib import Path

import numpy as np

from fourm_tpu.utils.text_tokenizer import (generate_coord_tokens, generate_sentinel_tokens,
                                            train_unified_wordpiece_tokenizer)
from fourm_torch import kernels

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_end_to_end_demo_on_the_cpu(tmp_path):
    import contextlib

    stages = []

    def stage(name, module):
        stages.append((name, type(module).__name__))
        return contextlib.nullcontext()

    kernels.reset_launch_counts()
    out = _example("end_to_end_demo_torch").main(
        device="cpu", train_steps=1, n_images=2, decoding_steps=2, workdir=str(tmp_path),
        stage=stage)
    assert stages == [("tokenize", "VQVAE"), ("train", "FourM"), ("generate", "FourM"),
                      ("decode", "VQVAE")]
    ref = train_unified_wordpiece_tokenizer(
        str(tmp_path / "corpus.txt"), vocab_size=500,
        sentinel_tokens=generate_sentinel_tokens(20), coord_tokens=generate_coord_tokens(10),
        show_progress=False)
    assert out["text_vocab"] == ref.get_vocab_size()
    assert len(list((tmp_path / "data" / "tok_rgb" / "c").iterdir())) == 2
    assert np.isfinite(out["loss"])
    tokens = out["tokens"]
    assert tokens.shape == (1, 196) and 0 <= tokens.min() and tokens.max() < 16384
    assert out["image"].shape == (1, 224, 224, 3) and np.isfinite(out["image"]).all()
    # the CPU runs the plain twins: nothing launched
    assert not any(kernels.launch_counts().values())


def test_retrieval_demo_on_the_cpu():
    out = _example("retrieval_demo_torch").main(device="cpu", gallery_size=2)
    sims = np.asarray(out["sims"])
    assert sims.shape == (2,) and np.isfinite(sims).all() and (np.abs(sims) <= 1 + 1e-6).all()
    assert sorted(out["ranking"]) == [0, 1]
