"""Vector quantization of the VQ tokenizers: inference and training.

Counterpart of fourm_tpu/vq/quantizer.py:VectorQuantize (reference
quantize_lucid.py:432-560): Euclidean or cosine codebook, multi-head
codebooks, `project_in` / `project_out`, `norm_latents`, and
`indices_to_embedding`. The nearest-code search goes through the
`nearest_code` / `nearest_code_cosine` kernels (their plain twins on the
CPU), which equal the JAX package's fp32 argmax up to summation order, in
inference and in a training step alike.

Training (`forward(x, train=True)`): the straight-through estimator, the
commitment loss and the orthogonal regulariser, then the codebook's EMA
update (`Codebook`: the buffers `embed`, `embed_avg`, `cluster_size`,
`initted`), Euclidean with Laplace-smoothed cluster sizes or cosine on the
normalised means, and dead-code expiry (`batch_random`: expired codes take
random batch rows; `linde_buzo_gray`: the most-used codes plus noise).
`kmeans` / `init_codebook_kmeans` initialise a codebook from a batch,
`gumbel_sample` samples codes. The EMA sums and the k-means means are fp32
products of one-hot assignments (TF32 off), summed in a fixed order, so a
step gives the same codebook on every run.

Randomness: each draw of the JAX step (gumbel noise, the expired codes'
batch rows or noise, k-means' first means) is an argument here (`draws`,
`init_idx`), drawn from an explicit torch.Generator when not given, so a
test can feed the JAX package's draws.

Data parallel (`group`, a process group over which the batch is split in
rank order; cli/train_vqvae.py sets it): the one-hot EMA sums are
all-reduced before the update, dead codes take their rows from the global
batch (all-gathered, the row index drawn over it from the shared
generator), k-means runs on the global batch, and gumbel noise is drawn for
the global batch, of which each rank takes its rows. So every rank keeps the
same codebook, the one a single process would keep on the global batch
(the JAX package's TestMultiDeviceVQ, tests/test_parallel.py:166).

Channel-last: latents (B, N, dim) -> (quantize (B, N, dim), indices
(B, N[, heads]), loss).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as tdist
from torch import nn

from ..kernels.vq_codebook import nearest_code, nearest_code_cosine
from ..ops.transformer import _dense

ONE_HOT_ROWS = 2048  # rows of a one-hot chunk in the EMA sums (2048 x K fp32)


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(p=2, dim=-1) (clamped norm), as the JAX package's l2norm."""
    return t / torch.clamp_min(torch.linalg.vector_norm(t, dim=-1, keepdim=True), eps)


@contextlib.contextmanager
def fp32_products():
    """Full fp32 products on the card for the block (TF32 off), as the JAX
    step's precision=HIGHEST."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The global batch's rows: every rank's t (equal shapes) concatenated
    along dim 0 in rank order (t itself without a group)."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def rank_rows(shape, group, generator, device, draw=torch.rand) -> torch.Tensor:
    """A draw of `shape` (this rank's rows first) made for the global batch
    from the shared generator, of which this rank's rows."""
    if group is None:
        return draw(shape, generator=generator, device=device)
    n, r = tdist.get_world_size(group), tdist.get_rank(group)
    full = draw((shape[0] * n,) + tuple(shape[1:]), generator=generator, device=device)
    return full[r * shape[0]:(r + 1) * shape[0]]


def euclidean_distance_logits(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """-(||x||^2 - 2 x.embed^T + ||embed||^2) in fp32 (quantizer.py:46-55).
    x (N, D), embed (K, D) -> (N, K)."""
    x, e = x.float(), embed.float().t()
    with fp32_products():
        return -(x.square().sum(1, keepdim=True) - 2.0 * (x @ e) + e.square().sum(0, keepdim=True))


def gumbel_sample(logits: torch.Tensor, temperature: float,
                  uniform: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """argmax for temperature 0, else the argmax of logits / temperature plus
    gumbel noise -log(-log(u + 1e-20)), u uniform in [1e-20, 1)
    (quantizer.py:58-63); `uniform` is u, else drawn from `generator`."""
    if temperature == 0:
        return logits.argmax(-1)
    if uniform is None:
        uniform = torch.rand(logits.shape, generator=generator, device=logits.device)
        uniform = uniform * (1.0 - 1e-20) + 1e-20
    noise = -torch.log(-torch.log(uniform + 1e-20))
    return (logits / temperature + noise).argmax(-1)


def cluster_sums(ind: torch.Tensor, rows: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """(counts (k,), sums (k, D)) of `rows` (N, D) by cluster `ind` (N,):
    fp32 one-hot products in chunks of ONE_HOT_ROWS rows, added in order
    (deterministic, TF32 off)."""
    counts = torch.bincount(ind, minlength=k).float()
    sums = torch.zeros(k, rows.shape[1], dtype=torch.float32, device=rows.device)
    with fp32_products():
        for i in range(0, rows.shape[0], ONE_HOT_ROWS):
            chunk = ind[i:i + ONE_HOT_ROWS]
            onehot = torch.zeros(chunk.shape[0], k, dtype=torch.float32, device=rows.device)
            onehot.scatter_(1, chunk[:, None], 1.0)
            sums += onehot.t() @ rows[i:i + ONE_HOT_ROWS].float()
    return counts, sums


def nearest(x: torch.Tensor, embed: torch.Tensor, cosine: bool) -> torch.Tensor:
    """The nearest code of each fp32 row through the search kernels (their
    twins on the CPU): cosine rows and codes must be l2-normalised."""
    search = nearest_code_cosine if cosine else nearest_code
    return search(x.float().contiguous(), embed.float().contiguous())


def kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int = 10,
           use_cosine_sim: bool = False, init_idx: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means codebook init (quantizer.py:66-94; reference
    quantize_lucid.py:139-170): samples (N, D) fp32 -> (means (K, D), bins
    (K,)). The first means are samples[init_idx], else a random
    permutation's first K rows (N >= K) or K random rows, drawn from
    `generator`. Assignments through the search kernels; a cluster left
    empty keeps its mean."""
    n = samples.shape[0]
    dev = samples.device
    if init_idx is None:
        init_idx = (torch.randperm(n, generator=generator, device=dev)[:num_clusters]
                    if n >= num_clusters else
                    torch.randint(0, n, (num_clusters,), generator=generator, device=dev))
    means = samples[init_idx.to(dev)]
    for _ in range(num_iters):
        buckets = nearest(samples, means, use_cosine_sim)
        bins, sums = cluster_sums(buckets, samples, num_clusters)
        new_means = sums / bins.clamp_min(1.0)[:, None]
        if use_cosine_sim:
            new_means = l2norm(new_means)
        means = torch.where((bins == 0)[:, None], means, new_means)
    bins = torch.bincount(nearest(samples, means, use_cosine_sim), minlength=num_clusters)
    return means, bins.float()


def orthogonal_loss_fn(codes: torch.Tensor) -> torch.Tensor:
    """The ViT-VQGAN orthogonality regulariser (quantizer.py:97-102)."""
    n = codes.shape[0]
    normed = l2norm(codes.float())
    with fp32_products():
        cos = normed @ normed.t()
    eye = torch.eye(n, dtype=torch.float32, device=codes.device)
    return (cos - eye).square().sum() / (n ** 2)


class Codebook(nn.Module):
    """The quantizer's codebook state, buffers under the reference's names
    (`quantize._codebook.*`): `embed` (K, codebook_dim) fp32, the EMA sums
    `embed_avg` (K, codebook_dim), the EMA cluster sizes `cluster_size`
    (K,), and `initted` (1. once initialised, 0. while k-means init is
    pending), as the JAX package's codebook collection (quantizer.py:
    142-159)."""

    def __init__(self, codebook_size: int, codebook_dim: int, kmeans_init: bool = False):
        super().__init__()
        self.register_buffer("embed", torch.zeros(codebook_size, codebook_dim))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, codebook_dim))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("initted", torch.tensor(0.0 if kmeans_init else 1.0))


class VectorQuantize(nn.Module):
    def __init__(self, dim: int, codebook_size: int, codebook_dim: Optional[int] = None,
                 heads: int = 1, use_cosine_sim: bool = False, norm_latents: bool = False,
                 decay: float = 0.8, eps: float = 1e-5, threshold_ema_dead_code: float = 0.0,
                 code_replacement_policy: str = "batch_random", commitment_weight: float = 1.0,
                 orthogonal_reg_weight: float = 0.0, sample_codebook_temp: float = 0.0,
                 kmeans_init: bool = False):
        super().__init__()
        cdim = codebook_dim or dim
        if code_replacement_policy not in ("batch_random", "linde_buzo_gray"):
            raise ValueError(f"invalid code replacement policy {code_replacement_policy}")
        self.heads, self.use_cosine_sim, self.norm_latents = heads, use_cosine_sim, norm_latents
        self.codebook_size = codebook_size
        self.decay, self.eps = decay, eps
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.code_replacement_policy = code_replacement_policy
        self.commitment_weight = commitment_weight
        self.orthogonal_reg_weight = orthogonal_reg_weight
        self.sample_codebook_temp = sample_codebook_temp
        self.requires_projection = cdim * heads != dim
        if self.requires_projection:
            self.project_in = nn.Linear(dim, cdim * heads)
            self.project_out = nn.Linear(cdim * heads, dim)
        self._codebook = Codebook(codebook_size, cdim, kmeans_init)

    group = None  # the data-parallel process group, if any (see the module docstring)

    @property
    def codebook(self) -> torch.Tensor:
        return self._codebook.embed

    def _project(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """nn.Dense without a dtype: computed in the input's and the
        parameters' promoted dtype, as flax does."""
        return _dense(x, lin, torch.promote_types(x.dtype, lin.weight.dtype))

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        """Projection, head split, norm_latents: (B * heads, N, cdim)."""
        B = x.shape[0]
        if self.requires_projection:
            x = self._project(self.project_in, x)
        if self.heads > 1:
            x = x.reshape(B, x.shape[1], self.heads, -1).transpose(1, 2)
            x = x.reshape(B * self.heads, x.shape[2], -1)
        if self.norm_latents:
            x = l2norm(x)
        return x

    def search_inputs(self, x: torch.Tensor):
        """The fp32 (B*heads*N, cdim) rows and (K, cdim) codebook the search
        compares (l2-normalised for cosine), and the shape of x after the
        head split."""
        x = self._split(x)
        flatten = x.float().reshape(-1, x.shape[-1])
        embed = self.codebook
        if self.use_cosine_sim:
            return l2norm(flatten), l2norm(embed), x.shape
        return flatten, embed, x.shape

    def _merge(self, quantize, ind, B: int, orig_dtype):
        if self.heads > 1:
            quantize = quantize.reshape(B, self.heads, -1, quantize.shape[-1]).transpose(1, 2)
            quantize = quantize.reshape(B, quantize.shape[1], -1)
            ind = ind.reshape(B, self.heads, -1).transpose(1, 2)
        quantize = quantize.to(orig_dtype)
        if self.requires_projection:
            quantize = self._project(self.project_out, quantize)
        return quantize, ind

    def forward(self, x: torch.Tensor, train: bool = False,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """(quantize, indices, loss). With train=True: the straight-through
        quantize, the commitment (+ orthogonal) loss, and the EMA update of
        the codebook buffers in place. `draws` ({"gumbel_u": (N, K)
        uniforms, "expire_idx": (K,) batch rows, "expire_noise": (K, cdim)
        normals}) are the step's random draws; those missing are drawn from
        `generator`."""
        if train:
            return self._train_forward(x, draws or {}, generator)
        B = x.shape[0]
        flatten, embed, shape = self.search_inputs(x)
        ind = nearest(flatten, embed, self.use_cosine_sim)
        quantize = self.codebook[ind].reshape(shape[:-1] + (-1,))
        quantize, ind = self._merge(quantize, ind.reshape(shape[:-1]), B, x.dtype)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        return quantize, ind, loss

    def _train_forward(self, x, draws, generator):
        B = x.shape[0]
        orig_dtype = x.dtype
        xs = self._split(x)
        x32 = xs.float()
        flatten = x32.reshape(-1, x32.shape[-1])
        embed = self.codebook.clone()
        flatten_n = l2norm(flatten) if self.use_cosine_sim else flatten
        with torch.no_grad():
            if self.sample_codebook_temp > 0:
                dist = ((flatten_n @ l2norm(embed).t()) if self.use_cosine_sim
                        else euclidean_distance_logits(flatten, embed))
                u = draws.get("gumbel_u")
                if u is None and self.group is not None:
                    u = rank_rows(dist.shape, self.group, generator, dist.device)
                    u = u * (1.0 - 1e-20) + 1e-20
                ind = gumbel_sample(dist, self.sample_codebook_temp, u, generator)
            else:
                ind = nearest(flatten_n, l2norm(embed) if self.use_cosine_sim else embed,
                              self.use_cosine_sim)
            self._ema_update(flatten_n.detach(), ind, x32.detach(), draws, generator)
        quantize = embed[ind].reshape(x32.shape)
        quantize = x32 + (quantize - x32).detach()  # straight-through estimator
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.commitment_weight > 0:
            loss = loss + self.commitment_weight * (quantize.detach() - x32).square().mean()
        if self.orthogonal_reg_weight > 0:
            loss = loss + self.orthogonal_reg_weight * orthogonal_loss_fn(embed)
        quantize, ind = self._merge(quantize, ind.reshape(x32.shape[:-1]), B, orig_dtype)
        return quantize, ind, loss

    # ------------------------------------------------------------------ EMA

    def _ema_update(self, flatten, ind, batch_samples, draws, generator):
        """The codebook's EMA step (quantizer.py:217-246), in place."""
        cb, d = self._codebook, self.decay
        bins, embed_sum = cluster_sums(ind, flatten, self.codebook_size)
        if self.group is not None:  # the global batch's sums
            sums = torch.cat([bins[:, None], embed_sum], 1)
            tdist.all_reduce(sums, group=self.group)
            bins, embed_sum = sums[:, 0], sums[:, 1:]
        cb.cluster_size.copy_(d * cb.cluster_size + (1 - d) * bins)
        if self.use_cosine_sim:
            normalized = l2norm(embed_sum / bins.clamp_min(1.0)[:, None])
            normalized = torch.where((bins == 0)[:, None], cb.embed, normalized)
            cb.embed.copy_(d * cb.embed + (1 - d) * normalized)
        else:
            cb.embed_avg.copy_(d * cb.embed_avg + (1 - d) * embed_sum)
            n = cb.cluster_size.sum()
            smoothed = (cb.cluster_size + self.eps) / (n + self.codebook_size * self.eps) * n
            cb.embed.copy_(cb.embed_avg / smoothed[:, None])
        if self.threshold_ema_dead_code > 0:
            self._expire_codes(batch_samples, draws, generator)

    def _expire_codes(self, batch_samples, draws, generator):
        """Dead-code replacement (quantizer.py:196-215): every code whose EMA
        cluster size is below the threshold takes a random batch row
        (l2-normalised), or the i-th expired code the i-th most-used code
        plus 1e-10 noise (linde_buzo_gray)."""
        cb, K = self._codebook, self.codebook_size
        expired = cb.cluster_size < self.threshold_ema_dead_code
        embed = cb.embed
        if self.code_replacement_policy == "batch_random":
            flat = l2norm(gather_rows(batch_samples, self.group)
                          .reshape(-1, batch_samples.shape[-1]))
            idx = draws.get("expire_idx")
            if idx is None:
                idx = torch.randint(0, flat.shape[0], (K,), generator=generator,
                                    device=flat.device)
            replacement = flat[idx.to(flat.device)]
        else:
            order = torch.argsort(-cb.cluster_size, stable=True)
            dead_rank = torch.cumsum(expired.int(), 0) - 1
            src = order[dead_rank.clamp(0, K - 1)]
            noise = draws.get("expire_noise")
            if noise is None:
                noise = torch.randn(embed.shape, generator=generator, device=embed.device)
            replacement = l2norm(embed[src] + noise.to(embed.device) * 1e-10)
        cb.embed.copy_(torch.where(expired[:, None], replacement, embed))

    def init_codebook_kmeans(self, data: torch.Tensor, init_idx: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None) -> None:
        """k-means init from a batch of latents (..., codebook_dim)
        (quantizer.py:182-192; reference quantize_lucid.py:222-233): embed,
        embed_avg and cluster_size from `kmeans`, initted set."""
        with torch.no_grad():
            flat = gather_rows(data, self.group).reshape(-1, data.shape[-1]).float()
            if self.use_cosine_sim:
                flat = l2norm(flat)
            means, bins = kmeans(flat, self.codebook_size, use_cosine_sim=self.use_cosine_sim,
                                 init_idx=init_idx, generator=generator)
            cb = self._codebook
            cb.embed.copy_(means)
            cb.embed_avg.copy_(means)
            cb.cluster_size.copy_(bins)
            cb.initted.fill_(1.0)

    def indices_to_embedding(self, indices: torch.Tensor) -> torch.Tensor:
        """Codebook lookup + output projection, channel-last:
        (B, ...) -> (B, ..., dim)."""
        emb = self.codebook[indices]
        if self.heads > 1:
            emb = emb.reshape(emb.shape[:-2] + (-1,))
        if self.requires_projection:
            emb = self._project(self.project_out, emb)
        return emb
