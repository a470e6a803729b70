"""The entry points of training over several processes, on the CPU (gloo,
world 2):

  * `python -m torch.distributed.run --nproc_per_node 2 -m
    fourm_torch.cli.train_4m --device cpu --synthetic_data --fsdp 2` at
    width 64: one JSONL log, written by rank 0 alone, whose losses equal a
    one-process run at twice the per-card batch (the same global batch;
    within rtol 1e-5), and whose checkpoint resumes in one process (the
    third step's loss equal to an uninterrupted one-process run's);
  * `python -m torch.distributed.run --nproc_per_node 2 -m
    fourm_torch.cli.train_vqvae` (k-means init, dead codes) against one
    process at twice the batch: the codebook and the parameters after 3
    steps;
  * TestMultiDeviceVQ's two checks (tests/test_parallel.py:166) on the
    port's quantizer at world 2, each rank on half of the batch, against
    the JAX quantizer on the whole batch with its draws: the indices, the
    loss and the codebook's embed / embed_avg / cluster_size (rtol 1e-5,
    atol 1e-6), every rank's codebook bit for bit equal, dead-code expiry
    included;
  * launch.initialize_multihost does nothing in one process, and raises at
    WORLD_SIZE=2 when the group cannot form.
"""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parallel_child import spawn
from fourm_tpu.vq import quantizer as jq

REPO = Path(__file__).resolve().parents[1]
MODEL = ["--model", "fm_base_12e_12d_swiglu_qknorm_nobias", "--dim", "64", "--encoder_depth",
         "2", "--decoder_depth", "2", "--num_heads", "2", "--in_domains",
         "tok_rgb@224-caption", "--out_domains", "tok_rgb@224-caption", "--synthetic_data",
         "--num_input_tokens", "32", "--num_target_tokens", "32", "--total_tokens", "0.0001",
         "--warmup_tokens", "0.00001", "--scheduler", "constant", "--print_freq", "1",
         "--eval_size", "4", "--epoch_size", "8", "--save_ckpt_freq", "1", "--run_name", "t",
         "--device", "cpu"]


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(module, args, timeout=300):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()), "-m", module,
           *args]
    r = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def _one(module, args, timeout=300):
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def _log(path):
    return [json.loads(line) for line in (path / "t" / "log.txt").read_text().splitlines()]


def test_train_4m_under_torchrun_fsdp(tmp_path):
    two, full = tmp_path / "two", tmp_path / "full"
    out = _torchrun("fourm_torch.cli.train_4m",
                    MODEL + ["--batch_size", "2", "--fsdp", "2", "--max_steps", "2",
                             "--output_dir", str(two)])
    assert "mesh={'data': 1, 'fsdp': 2, 'tensor': 1} global_bs=4" in out
    assert out.count("step 0/2") == 1 and out.count("training done") == 1  # rank 0 prints
    _one("fourm_torch.cli.train_4m", MODEL + ["--batch_size", "4", "--max_steps", "3",
                                              "--output_dir", str(full)])
    got, ref = _log(two), _log(full)
    train = [r for r in got if "loss" in r]
    assert [r["step"] for r in train] == [0, 1]  # one writer
    for g, r in zip(train, ref):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-5, atol=1e-6)
    evals = [r for r in got if "eval_loss" in r]
    assert [r["step"] for r in evals] == [2]
    np.testing.assert_allclose(evals[-1]["eval_loss"],
                               [r for r in ref if r.get("step") == 2 and "eval_loss" in r][0]
                               ["eval_loss"], rtol=1e-5)
    assert sorted(os.listdir(two / "t" / "checkpoints")) == ["step_2"]
    assert sorted(os.listdir(two / "t")) == ["checkpoints", "config.json", "log.txt",
                                             "weights"]
    # the world-2 checkpoint resumes in one process: step 2 equals the
    # uninterrupted one-process run's
    out = _one("fourm_torch.cli.train_4m", MODEL + ["--batch_size", "4", "--max_steps", "3",
                                                    "--output_dir", str(two)])
    assert "resumed from step 2" in out
    third = [r for r in _log(two) if "loss" in r][-1]
    assert third["step"] == 2
    np.testing.assert_allclose(third["loss"], [r for r in ref if "loss" in r][2]["loss"],
                               rtol=1e-5, atol=1e-6)


VQ_ARGS = ["--device", "cpu", "--dtype", "float32", "--input_size", "32", "--patch_size", "4",
           "--enc_type", "vit_t_enc", "--dec_type", "vit_t_dec", "--latent_dim", "8",
           "--codebook_size", "64", "--post_mlp", "--total_steps", "3", "--warmup_steps", "0",
           "--synthetic_data", "--print_freq", "1", "--eval_freq", "100", "--save_ckpt_freq", "100",
           "--threshold_ema_dead_code", "0.5", "--kmeans_init"]


def test_train_vqvae_data_parallel(tmp_path):
    out = _torchrun("fourm_torch.cli.train_vqvae",
                    VQ_ARGS + ["--batch_size", "2", "--output_dir", str(tmp_path / "two")])
    assert out.count("tokenizer training done") == 1
    _one("fourm_torch.cli.train_vqvae", VQ_ARGS + ["--batch_size", "4", "--output_dir",
                                                   str(tmp_path / "one")])
    a = torch.load(tmp_path / "two" / "checkpoints" / "step_3" / "state.pt")
    b = torch.load(tmp_path / "one" / "checkpoints" / "step_3" / "state.pt")
    for k in ("embed", "embed_avg", "cluster_size", "initted"):
        np.testing.assert_allclose(a["codebook"][k].numpy(), b["codebook"][k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k, t in b["params"].items():
        np.testing.assert_allclose(a["params"][k].numpy(), t.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    with pytest.raises(NotImplementedError, match="does not shard"):
        from fourm_torch.cli import train_vqvae

        train_vqvae.main(VQ_ARGS + ["--fsdp", "2", "--output_dir", str(tmp_path / "f")])


def _sub_rng(module, variables, key):
    return module.apply(variables, method=lambda m: m.make_rng("rng"), rngs={"rng": key})


def _vq_case(threshold, seed):
    kw = dict(dim=8, codebook_size=32, decay=0.5, threshold_ema_dead_code=threshold)
    jm = jq.VectorQuantize(**kw)
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 16, 8).astype(np.float32)
    embed = rng.randn(32, 8).astype(np.float32)
    cb = {"embed": embed, "embed_avg": embed.copy(),
          "cluster_size": np.abs(rng.randn(32)).astype(np.float32),
          "initted": np.float32(1.0)}
    key = jax.random.key(seed)
    (q, ind, loss), mut = jax.jit(lambda xx: jm.apply({"codebook": cb}, xx, train=True,
                                                      mutable=["codebook"],
                                                      rngs={"rng": key}))(jnp.asarray(x))
    qkey = _sub_rng(jm, {"codebook": cb}, key)
    draws = {"expire_idx": np.asarray(jax.random.randint(qkey, (32,), 0, 8 * 16))}
    job = dict(kind="vq", name=f"vq{threshold}", kwargs=kw, codebook=cb, x=x, draws=draws)
    return job, dict(ind=np.asarray(ind), loss=float(loss), cb=jax.tree.map(np.asarray,
                                                                             mut["codebook"]))


def test_multi_device_vq_checks(tmp_path):
    """tests/test_parallel.py's TestMultiDeviceVQ on the port: a batch-split
    training forward gives the whole batch's indices, loss and codebook, and
    dead-code expiry (threshold 100: every code expires) writes the same
    rows of the global batch on every rank."""
    cases = {t: _vq_case(t, s) for t, s in ((0.5, 0), (100.0, 3))}
    res = spawn(tmp_path, [job for job, _ in cases.values()])
    for t, (job, ref) in cases.items():
        got = res[job["name"]]
        ind = np.concatenate(got["ind"])
        assert np.array_equal(ind, ref["ind"]), t
        np.testing.assert_allclose(np.mean(got["loss"]), ref["loss"], rtol=1e-5)
        for k in ("embed", "embed_avg", "cluster_size"):
            np.testing.assert_allclose(got["codebook"][k].numpy(), ref["cb"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{t} {k}")
        e0, e1 = got["codebooks_equal"]
        assert torch.equal(e0, e1), t
    expired = ref["cb"]["cluster_size"] < 100.0
    assert expired.all()


def test_initialize_multihost():
    code = ("import torch.distributed as dist; "
            "from fourm_torch.parallel import launch; "
            "launch.initialize_multihost(); launch.initialize_multihost(device='cpu'); "
            "assert not dist.is_initialized() and launch.process_count() == 1 "
            "and launch.is_main_process()")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(), check=True, timeout=120)
    env = dict(_env(), WORLD_SIZE="2", RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    code = ("from fourm_torch.parallel import launch; "
            "launch.initialize_multihost(device='cpu', timeout_s=2)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "rank 0 of 2: the process group did not start" in r.stderr, \
        r.stderr[-2000:]
