#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fourm_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; imports
nothing of JAX or fourm_tpu. Phases, each printing its lines:
  1. the card (nvidia-smi name and power limit) and the kernel build, from
     fourm_torch/kernels/csrc, timed;
  2. every kernel of the port against its plain PyTorch twin on the card, in
     bf16 at the main path's shapes: max abs error against the stated
     tolerance, kernel ms, twin ms, a PyTorch library yardstick (never used
     by the port) and the least time the card could take (bound); for the
     decode-step rows also cold (kernel and yardstick over copies of the
     weights and caches above 100 MB taken in turn, time_rotating_ms); for
     self_decode, cross_decode_attn and decode_attention, wrong outputs (a
     cache position too many or too few, the new token left out; for the
     cross-attention the last split of decode_attention_plan left out, the
     first split's last 64-key tile left out, a stale V ring stage, and for
     cross_decode_attn q taken from the previous call's token, as a q read
     before the PDL wait would be, with the kernel held after a call on
     another token; for self_decode also the new k/v row not written, a 32-position cache tile
     left out, a split-K partial of Wqkv left out, a stale Wqkv ring stage,
     and, past 64 rows, the token rows of the second N tile left out; for
     residual_mlp a split-K partial of W2, a stale W2 stage, the second N
     tile's rows) that the tolerance must tell apart; self_decode and
     residual_mlp at B = 1, 17 and 65 with those faults, self_decode at L =
     32, 33 and 1100; and for flash_mha and attention (also with
     a per-query-row bias) the last, ragged key tile left out, each V tile
     read from two tiles back (a stale ring stage), K not normalised and a
     row's bias taken from the next query row; then the options off the
     path (ragged tile edges among them), for correctness only;
  2b. the kernels at the widths of 4M-21 XL (D = 2048, 32 heads, SwiGLU
     hidden 5461, the XL chain's shapes) and 4M-L (D = 1024, hidden 2730),
     and the int8 mode of cross_decode_attn at 4M-B and XL shapes, as phase
     2 (attention also at M = 2900 keys), with faults the tolerance must
     catch (phase 2's attention faults, ln_mlp's ragged tail chunk,
     W2's tail columns in residual_mlp, the K scale not folded, the V scale
     of the heads reversed, and phase 2's decode faults, the split plan's
     in the int8 mode too), with cold times beside the decode rows and two
     runs of self_decode, cross_decode_attn, decode_attention and
     residual_mlp at XL shapes held bit for bit; the int8 mode is also held to the bf16 kernel
     on the dequantized K/V, within 5% of the unquantized K/V, and
     quantize_kv_decode on the card to its CPU result, exactly; ln_matmul
     and ln_mlp also at the decoder grids (16 x 196 rows at 4M-B, 8 x 196 at
     XL), ln_mlp with the W2 tail columns its wrapper pads as a fault; and
     residual_mlp with the weights of an XL model built under
     torch.inference_mode() (depth 1 + 1) against its twin, before and
     after fc2's weight (hidden 5461, in the modules' zero-padded storage)
     is updated in place;
  2c. ln_matmul and ln_mlp at the narrow registry models' widths (D = 384:
     GELU hidden 1536, SwiGLU 1024; D = 512: SwiGLU 1365), as phase 2b;
  2d. the kernels at the SR-448 chain's shapes (4M-L, 8 rows: flash_mha
     without QK-norm over its longest stream, the cross-attention core at
     N = 784 against it, ln_matmul and ln_mlp over its rows, mha_short over
     the decoder grid) and the decoding at 448's (mha_short at the ViT-B
     decoders' 784 tokens, attention at the UViT-B's N = M = 784), as phase
     2, with phase 2's faults;
  3. the headline chain at full 4M-21 B width (fm_base_12e_12d_swiglu_qknorm_
     nobias on the 4M-21 modality sets, random bf16 weights from a seeded
     generator): FourMSampler decodes RGB -> all 14 targets of the default
     order (DEFAULTS_RGB2X: 8 image-token targets by one ROAR step with CFG
     2.0, then caption, det, human_poses, sam_instance, color_palette and
     metadata autoregressively) for 8 requests, with a stand-in for the text
     tokenizer's layout; after a warm-up run the launch counters are reset
     just before and read just after a run of the public entry alone (which
     gives samples/s), then a third, instrumented run times each sequence
     target; then the decode
     microbenchmark of bench.py (B = 16, L = 256, M = 2304, 64 greedy
     caption tokens) in bf16 and in int8 mode;
  4. one forward_generation_img at batch 2, and one ar_prefill + 4
     decode_one_token steps at batch 2, on the card (kernels, bf16) against
     the same weights on the CPU in fp32 (plain twins) and in bf16;
  10. (after phase 4) token decoding at the 4M-21 tokenizers' full width,
     random bf16 weights from seeded generators (every vector drawn too):
     FourMSampler.decode over phase 3's output (8 requests, rgb@224 and
     the 14 targets) with the ViT-B VQ-VAEs of CLIP-B16, DINOv2-B14,
     ImageBind-H14 and COCO semseg and the UNet-P4 DiVAEs of depth,
     normals, canny and SAM edges, 25 diffusion steps (12 for the edges),
     to_rgb without matplotlib; the launch counts of one call, reset just
     before and read just after it, checked exactly (48 attn_block, 48
     ln_mlp, nothing else); the wall time per call (the median of 3 after
     a warm-up) and each tokenizer's time from a fourth call; then the
     UViT-B DiVAE decoding 8 token grids at 25 steps (exactly 300 attention
     launches); then, against the same weights on the CPU in fp32 and in
     bf16 (phase 4's gate), each ViT-B decoder's output at batch 2, one
     denoise_step of the UNet-P4 (batch 1) and of the UViT-B (batch 2), a
     3-step divae_decode_tokens of the UNet-P4 fed the same noise, and the
     text, metadata, box and palette outputs of the card's decode equal to
     the CPU's decode_dict;
  3c. (after phase 10) the SR-448 chain of bench.py:508-533 at full width:
     4M-L (fm_large_24e_24d_swiglu_nobias, 24 + 24 layers, no QK-norm, on
     the 4M-21 modality sets and the @448 targets, random bf16 weights), 4
     requests conditioned on random rgb@224 pixels and tok_rgb@224 ids, the 5
     DEFAULT_ORDER_SR targets of 784 tokens through FourMSampler.generate (8
     MaskGIT cosine steps each, CFG 2.0): samples/s from the median of 3
     runs after a warm-up (which counts the host syncs, torch's sync debug
     mode), the launch counts of the first, checked exactly against the
     route of each block (sr_launches: the encoder past 1024 tokens through
     ln_matmul + flash_mha without QK-norm, the 784-token decoder grid
     through ln_matmul + mha_short, the cross-attention core, ln_mlp), s
     per target from an instrumented run; then FourMSampler(fm_sr=4M-L)
     .super_resolve of phase 3's 4M-B chain output (8 requests, its 9 @224
     entries -> 4 @448 targets), launch counts exact;
  10b. decoding at 448: FourMSampler.decode of phase 3c's tok_clip@448,
     tok_depth@448, tok_normal@448 and tok_semseg@448 through phase 10's
     ViT-B VQ-VAEs (28 x 28 grids, 784 tokens: ln_matmul + mha_short in
     place of attn_block) and UNet-P4 DiVAEs at 448 x 448, 25 steps, then
     the UViT-B DiVAE decoding 4 grids of 28 x 28 at 448 (tok_rgb@448's
     16384 ids do not fit its 1024 codes), each with exact launch counts,
     ms per call (median of 3), the peak device memory and ms and peak per
     tokenizer; the CLIP ViT-B decoder at batch 2, one UNet-P4 step and one
     UViT-B step at batch 1, at 448, against the CPU (phase 10c's gates);
  4c. one SR MaskGIT step (tok_depth@448, encoder budget 2048) at batch 2
     with 4M-L cut to 2 + 2 layers at full width, card bf16 against CPU
     fp32 and bf16 (phase 4's gate), launch counts exact;
  3f. the rest of the generation API at 4M-21 B full width: generate_iter's
     last yield bit for bit equal to generate's output (temperature 0, one
     seed; 4 MaskGIT, 2 ROAR and an AR target); generate_multi_guided with
     2 conditions at batch 2 (one forward of 6 rows, launch counts exact);
     generate_sam_dense over 4 replicas of a 32-token sam_instance region
     (the decode step's wrappers' launch counts exact);
  3b. the same chain at 4M-21 XL (fm_xlarge_24e_24d_swiglu_qknorm_nobias,
     full width and depth, random bf16 weights) for 4 requests, bench.py's
     xl_full_chain batch, in bf16 and then with kv_quant="int8" (every
     cross-attention decode step through decode_attention_int8), each with
     exact launch counts, and the two runs' token agreement (printed, not
     gated), then the decode microbenchmark at XL (24 layers) in both modes;
     4b. XL parity at depth cut to 2 + 2: one forward_generation_img and one
     ar_prefill + 4 decode steps (bf16, and int8 against the CPU's int8
     twins) at batch 2 against fp32 CPU runs;
  3d. the narrow registry models in bf16 through the kernels: the
     fm_tiny_6e_6d_gelu chain (8 requests, full depth) and, for it,
     fm_tiny_6e_6d_swiglu_nobias and fm_small_8e_8d_swiglu_nobias, phase
     4's parity at full depth, each with exact launch counts;
  3e. a float32 4M-21 B at 2 + 2 layers: the chain for 2 requests through
     the plain twins (the block layer's route for a model that does not
     compute in bf16) with no kernel launched, its forward against the
     CPU's fp32 run; a float32 mod-7 train step at 2 + 2 layers (the plain
     autograd attention, one fused_adamw launch) against the CPU's;
  5. the VQ tokenization kernels (attn_block, ln_mlp with exact GELU,
     mha_short, nearest_code, nearest_code_cosine) against their twins at the
     VQ paths' shapes, as phase 2 (the codebook searches must equal their
     twins index for index; beside their fp32 bound the bound of the TF32
     screen's own work; a codebook whose codes all tie, every code
     rescored, timed as a row), after the chain's phases so that they cannot
     move its figures; the searches in both forms, exactly, at N = 12544 on
     codebooks built against the screen (codes sharing their TF32 bits, near
     ties 1-4 ulps apart, duplicated codes, K below a tile), at D = 16, 128
     and 7, N = 1 and K = 1, with planted faults the exact gate must catch
     (the second-best code, the last index on ties, a code tile left out,
     the ragged last tile dropped, a zero margin on the TF32 collisions);
     and the longest sequence attn_block's library says its shared memory
     holds;
  6. VQ tokenization at ViT-B width, random bf16 weights from a seeded
     generator: (A) the RGB tokenizer of bench.py (VQ 224/16, vit_b_enc,
     16384 codes of 32, cosine) on 64 images, then its Euclidean variant,
     and (B) CLIP-B16 pretokenization (the ViTTeacher CLIP-B16 preset, then
     the CLIP tokenizer: 1x1 projection of 512 channels, post-MLP, 8192
     codes) on 64 images; each path's launch counts are reset just before
     and read just after one call, and checked exactly; images/s over 10
     timed calls;
  7. at batch 2, the VQ encoder latents and the teacher features on the card
     against the same weights on the CPU in fp32 and in bf16, the card's
     tokens against the plain search on the card's own latents (exact), and
     the agreement with the fp32 CPU tokens; 7b. the RGB tokenizer on
     448 x 448 inputs (positions resized bicubically) at batch 2, exact
     launch counts, against the CPU;
  8. the train step's kernels against their twins at its shapes, as phase
     2: attention_train forward (attention.cu's kernel with its row
     statistics) and backward (B = 32, 12 heads, N = M = 128) under a key
     and a full bias, with wrong outputs that the tolerance must tell apart
     (the backward without its D term, dk without its scale, the last key
     tile left out, the log2-unit statistics read as natural units, D of
     the other query tile), and fused_adamw over the 256 leaves of the 4M-B
     mod-7 tree, bit for bit; then the options off the path (no bias,
     softmax1, ragged tiles, AdamW at t = 1000, without decay, with the
     clip engaged); the backward at N = M = 512 and at N = 384, M = 200
     (two key-tile CTAs) with faults (a stale Q/dO ring stage, dq of the
     first key tile only); two backward runs bit for bit; and phase 2's
     flash_mha / attention rows re-timed, the forward sharing their kernel;
  9. bench.py's train step (4M-B mod-7, fm_base_12e_12d_swiglu_nobias, B =
     32, 128 + 128 tokens, bf16 compute over fp32 master weights from a
     seeded generator, AdamW) through fourm_torch.parallel.build_train_step:
     the launch counts of one step, reset just before and read just after
     it, checked exactly (36 + 36 attention_train, 1 fused_adamw, no
     inference kernel); samples/s as the median of 10 steps after 2
     warm-up steps, and the share of the bf16 peak; the loss over 13 steps
     on one batch at lr 1e-3 finite and falling. Then one step at batch 2
     against the same weights on the CPU in fp32 and in bf16 (the loss, the
     whole gradient and each of its 256 leaves), the card's update against
     the AdamW twin applied on the card to the card's own gradients
     (exact), and a planted fault (the cross-attention cores' dq zeroed)
     that the per-leaf gate must catch.
A kernel wrapper never runs its plain twin on the card: a call its kernel
does not take raises. The second-to-last line is the kernels' JSON (each row
also with its wrapper's launches on the decode paths of phase 10 and on the
SR paths of phases 3c and 10b); the last line is
{"ok": true, "device": {...}}. Any failed check raises: the exit code is then
not 0 and no result line is printed. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 CUDA-core rate (an FMA counts two)
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
MODEL = "fm_base_12e_12d_swiglu_qknorm_nobias"
# the 4M-21 modality sets (reference cfgs/default/4m/models/main/4m-b_mod21_*.yaml)
MOD21 = ("rgb@224", "tok_rgb@224", "tok_depth@224", "tok_normal@224", "tok_semseg@224",
         "tok_clip@224", "caption", "det", "t5_caption", "metadata", "human_poses",
         "color_palette", "sam_instance", "tok_canny_edge@224", "tok_sam_edge@224",
         "tok_dinov2@224", "tok_imagebind@224", "tok_dinov2_global", "tok_imagebind_global")
MOD21_DEC = tuple(m for m in MOD21 if m not in ("rgb@224", "t5_caption"))
ROAR_TARGETS = ["tok_clip@224", "tok_dinov2@224", "tok_imagebind@224", "tok_depth@224",
                "tok_normal@224", "tok_semseg@224", "tok_canny_edge@224", "tok_sam_edge@224"]
AR_TARGETS = ["caption", "det", "human_poses", "sam_instance", "color_palette", "metadata"]
TARGETS = ROAR_TARGETS + AR_TARGETS  # the default order without tok_rgb (bench.py:433)
REQUESTS = 8
DEPTH = 12
# 4M-21 XL (D = 2048, 32 heads, 24 + 24 layers, SwiGLU hidden 5461) for
# bench.py's xl_full_chain batch of 4 requests (bench.py:470-501)
XL_MODEL = "fm_xlarge_24e_24d_swiglu_qknorm_nobias"
XL_REQUESTS = 4
XL_DEPTH = 24
# VQ tokenization: the RGB tokenizer of bench.py:179-183 and the CLIP-B16
# tokenizer of cfgs/default/tokenization/vqvae/CLIP-B16/ViTB-ViTB_8k_224.yaml
VQ_BATCH = 64
VQ_RGB = dict(image_size=224, patch_size=16, enc_type="vit_b_enc", codebook_size=16384,
              latent_dim=32, norm_codes=True, dtype="bfloat16")
VQ_CLIP = dict(VQ_RGB, n_channels=512, patch_proj=False, post_mlp=True, codebook_size=8192)
# launches of one tokenize call (12 ViT-B blocks, one search), per path
PER_ENCODER = {"attn_block": DEPTH, "ln_mlp": DEPTH}
PER_VQ_PATH = {"vq_a": dict(PER_ENCODER, nearest_code_cosine=1),
               "vq_a_euclid": dict(PER_ENCODER, nearest_code=1),
               "vq_b": dict(PER_ENCODER, nearest_code_cosine=1, mha_short=DEPTH)}
# token decoding (phase 10): the 4M-21 tokenizers' decoders at full width,
# computing in bf16 as their configs do (cfgs/default/tokenization/**)
DECODE_STEPS = 25
TOK_VITB = dict(image_size=224, patch_size=16, enc_type="vit_b_enc", dec_type="vit_b_dec",
                post_mlp=True, latent_dim=32, norm_codes=True, dtype="bfloat16")
# vqvae/{CLIP-B16,DINOv2-B14,ImageBind-H14}/ViTB-ViTB_8k_224.yaml and
# vqvae/semseg_coco/ViTB-ViTB_4k_224.yaml
VQVAE_TOKENIZERS = {
    "tok_clip": dict(TOK_VITB, n_channels=512, patch_proj=False, codebook_size=8192),
    "tok_dinov2": dict(TOK_VITB, n_channels=768, patch_proj=False, codebook_size=8192),
    "tok_imagebind": dict(TOK_VITB, n_channels=1280, patch_proj=False, codebook_size=8192),
    "tok_semseg": dict(TOK_VITB, n_labels=134, codebook_size=4096),
}
# divae/{depth,normal,canny_edge}/ViTB-UNetP4_8k_224_predx0.yaml; the canny
# configuration stands for tok_sam_edge, which has none
DIVAE_UNETP4 = dict(TOK_VITB, dec_type="unet_patched", codebook_size=8192,
                    prediction_type="sample", beta_schedule="linear", zero_terminal_snr=False)
DIVAE_TOKENIZERS = ("tok_depth", "tok_normal", "tok_canny_edge", "tok_sam_edge")
# divae/rgb/ViTB-UViTB_1k_224_predv_frozenenc.yaml
DIVAE_UVITB = dict(TOK_VITB, dec_type="uvit_b_p4_f16", codebook_size=1024,
                   prediction_type="v_prediction", beta_schedule="squaredcos_cap_v2",
                   zero_terminal_snr=True)
# launches of one decode call (the 4 ViT-B decoders' 12 blocks; the UNets
# launch no kernel) and of one UViT-B decode (a mid block's attention core
# per layer and step)
PER_DECODE = {"attn_block": 4 * DEPTH, "ln_mlp": 4 * DEPTH}
PER_UVIT_DECODE = {"attention": 12 * DECODE_STEPS}
# the SR-448 chain of bench.py:508-533: 4M-L (D = 1024, 16 heads, 24 + 24
# layers, SwiGLU hidden 2730, no QK-norm) on the 4M-21 modality sets and the
# @448 targets (bench.py:103-106), 4 requests conditioned on rgb@224 and
# tok_rgb@224, the 5 DEFAULT_ORDER_SR targets by DEFAULTS_SR (8 MaskGIT
# cosine steps of the 784-token grid each, CFG 2.0: 8 rows)
SR_MODEL = "fm_large_24e_24d_swiglu_nobias"
SR_TARGETS = ["tok_clip@448", "tok_depth@448", "tok_normal@448", "tok_semseg@448", "tok_rgb@448"]
SR_MODS = (MOD21 + tuple(SR_TARGETS), MOD21_DEC + tuple(SR_TARGETS))
SR_CONDS = ["rgb@224", "tok_rgb@224"]
SR_REQUESTS, SR_STEPS, SR_GRID = 4, 8, 784
# the whole encoder stream at the last target: 196 + 196 condition tokens
# and the 5 grids (its budget would be no shorter)
SR_LONGEST = 2 * 196 + len(SR_TARGETS) * SR_GRID
# decoding at 448 (phase 10b): the SR chain's targets whose vocabulary a
# phase 10 tokenizer takes (tok_rgb@448's 16384 ids do not fit the UViT-B's
# 1024 codes, so the UViT-B decodes grids of its own codes, as at 224)
DECODE448_TARGETS = SR_TARGETS[:4]
# launches of one such decode: each of the 2 ViT-B decoders' 12 blocks at 784
# tokens, past attn_block's 448, ln_matmul + mha_short, then ln_mlp; the
# UNet-P4s launch no kernel
PER_DECODE448 = {"ln_matmul": 2 * DEPTH, "mha_short": 2 * DEPTH, "ln_mlp": 2 * DEPTH}
# the train step of bench.py:224-279: 4M-B on the 4M-7 modality sets, B = 32,
# 128 input and 128 target tokens, bf16 compute over fp32 master weights
TRAIN_MODEL = "fm_base_12e_12d_swiglu_nobias"
TRAIN_BATCH, TRAIN_TOKENS = 32, 128
TRAIN_PARAMS, TRAIN_LEAVES = 360_791_040, 256
# launches of one train step of a 12+12 model: each of its 36 attention cores
# (12 encoder self, 12 decoder self, 12 decoder cross) forward and backward,
# and one AdamW launch over every leaf
PER_TRAIN_STEP = {"attention_train_fwd": 3 * DEPTH, "attention_train_bwd": 3 * DEPTH,
                  "fused_adamw": 1}


class StandInTokenizer:
    """The layout of bench.py's text tokenizer, as far as generation reads
    it: [PAD]=0, [UNK]=1, [SOS]=2, [EOS]=3, then the sentinels [S_0] ..
    [S_19] = 4 .. 23 (the sentinel ids drive the span merge). Decoding
    names every other id as one of the value tokens v0=0 .. v3=999 (in
    turn), so that the metadata, box and palette parsers of token decoding
    find values in random-weight sequences."""

    def __init__(self):
        self.names = ["[PAD]", "[UNK]", "[SOS]", "[EOS]"] + [f"[S_{i}]" for i in range(20)]
        self.vocab = {t: i for i, t in enumerate(self.names)}

    def get_vocab(self):
        return dict(self.vocab)

    def token_to_id(self, token):
        return self.vocab[token]

    def decode(self, ids, skip_special_tokens=False):
        n = len(self.names)
        return " ".join(self.names[i] if i < n else f"v{(i - n) // 1000 % 4}={(i - n) % 1000}"
                        for i in ids)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn over `iters` launches, after one warm-up. A
    sleep kernel ahead of the start event keeps the card busy while the
    host queues the launches, so a call whose host side is slower than its
    kernels is timed by its kernels, not by the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 1e6))  # ~0.5 ms of the card per launch queued
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the weights and caches a cold row's copies hold together: twice the 50 MB L2
COLD_BYTES = 100 * 2**20


def cold_copies(nbytes: int) -> int:
    """Copies of a row's weights and caches (nbytes each) that hold more
    than COLD_BYTES together."""
    return max(2, COLD_BYTES // nbytes + 1)


def time_rotating_ms(torch, fns, iters: int) -> float:
    """Mean device time of the calls in `fns` taken in turn, as time_ms. Each
    call reads its own copy of the weights and caches, the copies together
    above COLD_BYTES, so that a call finds its weights and caches out of the
    50 MB L2 (cold), as on the decode chain, where each token sweeps every
    layer's weights; the token's activations are shared, warm, as the
    chain's were just written by the kernel before."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 1e6))
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_makers(torch, seed: int):
    """A seeded generator on the card, and from it makers of bf16 normal
    tensors and of fp32 (B, M) key biases (a fraction `frac` of the keys
    masked, the first `full_rows` rows wholly)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    neg = torch.finfo(torch.float32).min

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    def key_bias(B, M, frac=0.3, full_rows=0):
        bias = torch.where(torch.rand(B, M, generator=gen, device="cuda") < frac, neg, 0.0)
        bias[:full_rows] = neg
        return bias

    return gen, rn, key_bias


def held(torch, name, run, plain, faults=None, exact=False):
    """Kernel against twin. `run`/`plain` return one tensor or a dict of
    named parts, each held to its own tolerance (0 when `exact`: the
    codebook searches). `faults` (optional) gives wrong outputs that the
    first part's tolerance must tell from the twin's, so a kernel with
    such a fault could not pass."""
    outs, refs = run(), plain()
    if not isinstance(outs, dict):
        outs, refs = {"out": outs}, {"out": refs}
    torch.cuda.synchronize()
    parts = {}
    for part, out in outs.items():
        ref = refs[part].float()
        err = (out.float() - ref).abs().max().item()
        # two bf16 ulps of the part's largest value: kernel and twin
        # round the same fp32 sums to bf16, summed in different orders
        tol = 0.0 if exact else 2.0 ** -6 * ref.abs().max().item()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite {part}")
        check(err <= tol, f"{name}: {part}: max abs error {err} > tolerance {tol}")
        parts[part] = (err, tol)
    if faults is not None:
        fault_check(torch, name, faults, {p: r.float() for p, r in refs.items()},
                    {p: t for p, (_e, t) in parts.items()})
    return parts


def time_cases(torch, cases, card: str):
    """Hold each case's kernel to its twin, time kernel, twin and library
    yardstick, and reckon the bound. Returns the kernels' JSON rows."""
    results = []
    for name, replaces, source, c in cases:
        parts = held(torch, name, c.get("held_run", c["run"]), c.get("held_plain", c["plain"]),
                     c.get("faults"), c.get("exact", False))
        if "oracle" in c:
            c["oracle"]()
        err, tol = max(parts.values(), key=lambda et: et[0] / max(et[1], 1e-30))
        ms = time_ms(torch, c["run"], 10)
        plain_ms = time_ms(torch, c["plain"], 3)
        library_ms = time_ms(torch, c["library"], 10)
        cold = {}
        if "cold" in c:  # (kernel calls, library calls) over copies of the weights and caches
            runs, libs = c["cold"]()
            cold = {"cold_ms": time_rotating_ms(torch, runs, 2 * len(runs)),
                    "cold_library_ms": time_rotating_ms(torch, libs, 2 * len(libs))}
            del runs, libs
            torch.cuda.empty_cache()
        peak = c.get("peak", PEAK_BF16_FLOPS)
        bound_ms = max(c["flops"] / peak, c["bytes"] / PEAK_BYTES) * 1e3
        bound_by = "operations" if c["flops"] / peak >= c["bytes"] / PEAK_BYTES else "bytes"
        design = ""
        if "design" in c:  # the bound of the design's own work, beside the plain bound
            design = f", design bound {c['design'][0]:.4f} ms ({c['design'][1]})"
        errs = "; ".join(f"{p} max_abs_err {e:.6g} (tol {t:.6g})" for p, (e, t) in parts.items())
        # work the wrapper does beside its kernels, timed alone (inside ms)
        within = {w: time_ms(torch, fn, 10) for w, fn in c.get("within", {}).items()}
        cold_txt = (f", cold {cold['cold_ms']:.4f} ms (library {cold['cold_library_ms']:.4f} ms)"
                    if cold else "")
        print(f"kernel {name}: {c['shape']}: {errs}, "
              f"{ms:.4f} ms" + "".join(f" (of which {w} {t:.4f} ms)" for w, t in within.items())
              + f", plain {plain_ms:.4f} ms, library {library_ms:.4f} ms{cold_txt}, "
              f"bound {bound_ms:.4f} ms ({bound_by}){design}; {card}", flush=True)
        results.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "wrapper": c.get("wrapper", name.split("@")[0]),
                        "path": c.get("path", "chain"),
                        "max_abs_err": err, "tolerance": tol,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms, **cold,
                        "shape": c["shape"]})
        if within:
            results[-1]["within_ms"] = within
        if "design" in c:
            results[-1]["design_bound_ms"], results[-1]["design_bound_by"] = c["design"]
        if len(parts) > 1:
            results[-1]["parts"] = {p: {"max_abs_err": e, "tolerance": t}
                                    for p, (e, t) in parts.items()}
    return results


def hold_variants(torch, variants) -> None:
    """The options a path does not take, for correctness only."""
    for name, run, plain, *exact in variants:
        parts = held(torch, name, run, plain, exact=bool(exact))
        errs = "; ".join(f"{'' if p == 'out' else p + ' '}max_abs_err {e:.6g} (tol {t:.6g})"
                         for p, (e, t) in parts.items())
        print(f"variant {name}: {errs}", flush=True)


def ln_matmul_row(torch, rn, gen, rows: int, D: int, Fo: int, biases: bool = False,
                  path: str = "chain"):
    """A ln_matmul row: x (rows, D) -> (rows, Fo), with LN shift and bias or
    none; the library yardstick is F.layer_norm + F.linear."""
    import torch.nn.functional as F

    from fourm_torch.kernels import fused_mlp as fm

    x = rn(rows, D)
    gamma = torch.rand(D, generator=gen, device="cuda") + 0.5
    beta = torch.randn(D, generator=gen, device="cuda") if biases else None
    w = rn(Fo, D, std=D ** -0.5)
    b = torch.randn(Fo, generator=gen, device="cuda") if biases else None
    lb = None if beta is None else beta.to(torch.bfloat16)
    lbias = None if b is None else b.to(torch.bfloat16)
    return dict(
        run=lambda: fm.ln_matmul(x, gamma, beta, w, b),
        plain=lambda: fm.ln_matmul_plain(x, gamma, beta, w, b),
        library=lambda: F.linear(F.layer_norm(x, (D,), gamma.to(torch.bfloat16), lb, 1e-6), w,
                                 lbias),
        flops=2 * rows * D * Fo, bytes=(rows * D + Fo * D + rows * Fo) * 2 + D * 4, path=path,
        shape=f"x ({rows}, {D}) -> ({rows}, {Fo}), {'LN bias + bias' if biases else 'no biases'}")


def ln_mlp_row(torch, rn, gen, rows: int, D: int, HID: int, gated: bool, biases: bool = False,
               path: str = "chain", w2_tail_gain: float = 1.0):
    """A ln_mlp row: SwiGLU or exact GELU at (rows, D), hidden HID. For a
    hidden width that is not a multiple of the GEMM's 128-unit tile, faults
    the tolerance must catch: the ragged tail tile left out, and, when HID %
    8 != 0, W2's tail columns (the units the wrapper's zero-padded copy of
    W2 carries, scaled by w2_tail_gain so that they matter) left out."""
    import torch.nn.functional as F

    from fourm_torch.kernels import fused_mlp as fm

    x = rn(rows, D)
    gamma = torch.rand(D, generator=gen, device="cuda") + 0.5
    beta = torch.randn(D, generator=gen, device="cuda") if biases else None
    w1, w3 = rn(HID, D, std=D ** -0.5), rn(HID, D, std=D ** -0.5)
    w2 = rn(D, HID, std=HID ** -0.5)
    tail8 = HID // 8 * 8
    w2[:, tail8:] *= w2_tail_gain
    b1, b3 = (torch.randn(HID, generator=gen, device="cuda") if biases else None
              for _ in range(2))
    b2 = torch.randn(D, generator=gen, device="cuda") if biases else None
    if not gated:
        w3 = b3 = None
    args = (x, gamma, beta, w1, b1, w2, b2, w3, b3)

    def library():
        bf = torch.bfloat16
        h = F.layer_norm(x, (D,), gamma.to(bf), None if beta is None else beta.to(bf), 1e-6)
        c = [None if t is None else t.to(bf) for t in (b1, b2, b3)]
        g = F.linear(h, w1, c[0])
        act = F.silu(g) * F.linear(h, w3, c[2]) if gated else F.gelu(g)
        return x + F.linear(act, w2, c[1])

    def cut_plain(units):
        return fm.ln_mlp_plain(x, gamma, beta, w1[:units], None if b1 is None else b1[:units],
                               w2[:, :units].contiguous(), b2,
                               None if w3 is None else w3[:units],
                               None if b3 is None else b3[:units], gated=gated).float()

    def faults():
        wrong = {}
        if HID % 128:
            wrong[f"the ragged tail tile ({HID % 128} units) left out"] = cut_plain(HID // 128 * 128)
        if HID % 8:
            wrong[f"W2's tail columns ({HID - tail8} units at {w2_tail_gain}x) left out"] = \
                cut_plain(tail8)
        return fm.ln_mlp_plain(*args, gated=gated).float(), wrong, set(wrong)

    kind = "SwiGLU" if gated else "exact GELU"
    return dict(
        run=lambda: fm.ln_mlp(*args, gated=gated),
        plain=lambda: fm.ln_mlp_plain(*args, gated=gated),
        library=library, path=path, faults=faults if HID % 128 else None,
        # the zero-padded copy of a ragged W2 that the wrapper makes per call
        within={"the W2 pad copy": lambda: F.pad(w2, (0, 8 - HID % 8))} if HID % 8 else {},
        flops=(3 if gated else 2) * 2 * rows * D * HID,
        bytes=(2 * rows * D + (3 if gated else 2) * D * HID) * 2 + D * 4,
        shape=f"{kind}, x ({rows}, {D}), hidden {HID}, "
              f"{'LN bias + biases' if biases else 'no biases'}")


ATTENTION_CU = "fourm_torch/kernels/csrc/attention.cu"


def flash_row(torch, rn, key_bias, g64, B: int, N: int, D: int = 768, H: int = 12):
    """A flash_mha row: q, k, v (B, N, D) slices of one QKV buffer, QK-norm
    (LN parameters g64; None: no QK-norm, as at 4M-L), a key bias with one
    batch row fully masked; the library yardstick is SDPA on the
    (normalised) heads."""
    import torch.nn.functional as F

    from fourm_torch.kernels import attention as at

    bf, Dh = torch.bfloat16, D // H
    qkv = rn(B, N, 3 * D)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    bias = key_bias(B, N, full_rows=1)
    norms = (None,) * 4 if g64 is None else tuple(g64)
    args = (q, k, v, H, bias, *norms)
    qn, kn = q.reshape(B, N, H, Dh), k.reshape(B, N, H, Dh)
    if g64 is not None:
        qn = F.layer_norm(qn.float(), (Dh,), g64[0], g64[1], 1e-6).to(bf)
        kn = F.layer_norm(kn.float(), (Dh,), g64[2], g64[3], 1e-6).to(bf)
    qn, kn = qn.transpose(1, 2), kn.transpose(1, 2)
    vh, mask = v.reshape(B, N, H, Dh).transpose(1, 2), bias[:, None, None, :].to(bf)
    return dict(
        run=lambda: at.flash_mha(*args), plain=lambda: at.flash_mha_plain(*args),
        library=lambda: F.scaled_dot_product_attention(qn, kn, vh, attn_mask=mask),
        faults=lambda: mha_faults(q, k, v, H, bias, norms),
        flops=4 * B * H * N * N * Dh, bytes=4 * B * N * D * 2 + B * N * 4,
        shape=f"q,k,v (B={B}, N=M={N}, C={D}) slices of QKV, {H} heads, "
              f"{'no QK-norm' if g64 is None else 'QK-norm'}, key bias")


def attention_row(torch, rn, gen, key_bias, B: int, N: int, M: int, full_rows: int = 0,
                  row_bias: bool = False, H: int = 12):
    """An attention row: (B, H, N|M, 64) q, k, v and a (B, 1, 1, M) key bias
    (`full_rows` batch rows fully masked) or a (B, 1, N, M) bias (query row 3
    fully masked); the library yardstick is SDPA."""
    import torch.nn.functional as F

    from fourm_torch.kernels import attention as at

    Dh = 64
    q, k, v = rn(B, H, N, Dh), rn(B, H, M, Dh), rn(B, H, M, Dh)
    if row_bias:  # one bias row per query, query row 3 fully masked
        bias = torch.randn(B, 1, N, M, generator=gen, device="cuda")
        bias[:, :, 3] = torch.finfo(torch.float32).min
    else:
        bias = key_bias(B, M, full_rows=full_rows)[:, None, None, :]
    return dict(
        run=lambda: at.attention(q, k, v, bias),
        plain=lambda: at.attention_plain(q, k, v, bias),
        library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=bias.to(torch.bfloat16)),
        faults=lambda: attention_faults(q, k, v, bias),
        flops=4 * B * H * N * M * Dh,
        bytes=(2 * B * H * N * Dh + 2 * B * H * M * Dh) * 2 + bias.numel() * 4,
        shape=f"q (B={B}, {H}, N={N}, 64), k/v M={M}, "
              + ("(B, 1, N, M) bias, query row 3 fully masked" if row_bias else
                 "(B, 1, 1, M) bias")
              + (f", {full_rows} batch rows fully masked" if full_rows else ""))


def attention_rows(torch, rn, gen, key_bias, g64):
    """Phase 2's rows of csrc/attention.cu's kernel (flash_mha, attention);
    phase 8 re-times them beside the train step's forward."""

    def flash_case(B, N):
        return flash_row(torch, rn, key_bias, g64, B, N)

    def attn_case(B, N, M, full_rows=0, row_bias=False):
        return attention_row(torch, rn, gen, key_bias, B, N, M, full_rows, row_bias)

    return [
        ("flash_mha", "fourm_tpu/kernels/attention.py:587", ATTENTION_CU, flash_case(16, 2048)),
        ("flash_mha@N196", "fourm_tpu/kernels/attention.py:587", ATTENTION_CU,
         flash_case(16, 196)),
        ("attention", "fourm_tpu/kernels/attention.py:325", ATTENTION_CU,
         attn_case(16, 256, 2048)),
        ("attention@masked_rows", "fourm_tpu/kernels/attention.py:325", ATTENTION_CU,
         attn_case(16, 196, 512, full_rows=8)),
        ("attention@SR448", "fourm_tpu/kernels/attention.py:127", ATTENTION_CU,
         dict(attn_case(16, 784, 1536), path="sr_chain")),
        ("attention@row_bias", "fourm_tpu/kernels/attention.py:325", ATTENTION_CU,
         attn_case(16, 196, 512, row_bias=True)),
    ]


def mha_short_row(torch, rn, key_bias, B: int, N: int, C: int, H: int, with_bias: bool,
                  path: str):
    """A mha_short row: packed qkv (B, N, 3C) at 3x scale (peaked attention,
    so that a head or a key tile left out moves the output well past two
    bf16 ulps), a (B, N) key bias with one row fully masked or no mask;
    faults: mha_faults' and one head's output left out; the library
    yardstick is SDPA on the heads."""
    import torch.nn.functional as F

    from fourm_torch.kernels import attention as at

    Dh = C // H
    qkv = rn(B, N, 3 * C, std=3.0)
    bias = key_bias(B, N, full_rows=1) if with_bias else None
    heads = [t.reshape(B, N, H, Dh).transpose(1, 2) for t in qkv.split(C, dim=-1)]
    mask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)

    def faults():
        right, wrong, _ = mha_faults(*qkv.split(C, dim=-1), H, bias)
        no_head = right.clone()
        no_head[..., 5 * Dh:6 * Dh] = 0
        wrong["one head's output left out"] = no_head
        return right, wrong, set(wrong)

    return dict(
        run=lambda: at.mha_short(qkv, H, bias), plain=lambda: at.mha_short_plain(qkv, H, bias),
        faults=faults, path=path,
        library=lambda: F.scaled_dot_product_attention(*heads, attn_mask=mask),
        flops=4 * B * H * N * N * Dh, bytes=B * N * 4 * C * 2 + (B * N * 4 if with_bias else 0),
        shape=f"qkv (B={B}, N={N}, 3*{C}), {H} heads, "
              + ("(B, N) key bias, 1 row fully masked" if with_bias else "no mask"))


def kernel_phase(torch, card: str):
    """Phase 2: each kernel against its twin at the main path's shapes: the
    ROAR kernels, then the decode-step kernels."""
    import torch.nn.functional as F

    from fourm_torch.kernels import attention as at
    from fourm_torch.kernels import fused_mlp as fm

    dev = "cuda"
    gen, rn, key_bias = random_makers(torch, 0)
    bf = torch.bfloat16

    rows, D, H, Dh = 16 * 2048, 768, 12, 64
    x = rn(rows, D)
    gamma = torch.rand(D, generator=gen, device=dev) + 0.5
    w_qkv = rn(3 * D, D, std=D ** -0.5)
    w1, w3 = rn(2048, D, std=D ** -0.5), rn(2048, D, std=D ** -0.5)
    w2 = rn(D, 2048, std=2048 ** -0.5)
    g64 = [torch.rand(64, generator=gen, device=dev) + 0.5,
           torch.randn(64, generator=gen, device=dev) * 0.1] * 2

    def ln(t):
        return F.layer_norm(t, (D,), gamma.to(bf), None, 1e-6)

    def mlp_library(h):
        return x + F.linear(F.silu(F.linear(h, w1)) * F.linear(h, w3), w2)

    cases = [
        ("ln_matmul", "fourm_tpu/kernels/fused_mlp.py:181", "fourm_torch/kernels/csrc/ln_matmul.cu",
         dict(run=lambda: fm.ln_matmul(x, gamma, None, w_qkv),
              plain=lambda: fm.ln_matmul_plain(x, gamma, None, w_qkv),
              library=lambda: torch.matmul(ln(x), w_qkv.t()),
              flops=2 * rows * D * 3 * D, bytes=(rows * D + 3 * D * D + rows * 3 * D) * 2 + D * 4,
              shape="x (16*2048, 768) -> (16*2048, 2304), no biases")),
        ("ln_mlp", "fourm_tpu/kernels/fused_mlp.py:244", "fourm_torch/kernels/csrc/ln_mlp.cu",
         dict(run=lambda: fm.ln_mlp(x, gamma, None, w1, None, w2, None, w3, None, gated=True),
              plain=lambda: fm.ln_mlp_plain(x, gamma, None, w1, None, w2, None, w3, None,
                                            gated=True),
              library=lambda: mlp_library(ln(x)),
              flops=3 * 2 * rows * D * 2048, bytes=(2 * rows * D + 3 * D * 2048) * 2 + D * 4,
              shape="SwiGLU, x (16*2048, 768), hidden 2048, no biases")),
        ("ln_matmul@N196", "fourm_tpu/kernels/fused_mlp.py:181",
         "fourm_torch/kernels/csrc/ln_matmul.cu", ln_matmul_row(torch, rn, gen, 16 * 196, D, 3 * D)),
        ("ln_mlp@N196", "fourm_tpu/kernels/fused_mlp.py:244", "fourm_torch/kernels/csrc/ln_mlp.cu",
         ln_mlp_row(torch, rn, gen, 16 * 196, D, 2048, True)),
        *attention_rows(torch, rn, gen, key_bias, g64),
    ]
    decode_cases, decode_variants = decode_kernel_cases(torch, rn, key_bias, gen)
    results = time_cases(torch, cases + decode_cases, card)

    # options the main path does not take (biases, GELU, no QK-norm, softmax1,
    # a per-head query-dependent bias, ragged row counts): correctness only
    xr = x[:1000]
    beta, b_qkv = torch.randn(D, generator=gen, device=dev), torch.randn(3 * D, generator=gen,
                                                                          device=dev)
    wg1, wg2 = rn(3072, D, std=D ** -0.5), rn(D, 3072, std=3072 ** -0.5)
    bg1, bg2 = torch.randn(3072, generator=gen, device=dev), torch.randn(D, generator=gen,
                                                                         device=dev)
    qkv = rn(3, 300, 3 * D)
    mha = (qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], H, key_bias(3, 300, full_rows=1))
    q, k, v = rn(2, H, 100, Dh), rn(2, H, 333, Dh), rn(2, H, 333, Dh)
    full = torch.randn(2, H, 100, 333, generator=gen, device=dev)
    tiny = (rn(2, 5, 3 * D)[..., :D], rn(2, 7, 3 * D)[..., D:2 * D], rn(2, 7, 3 * D)[..., 2 * D:],
            H, key_bias(2, 7), *g64)
    qkv1 = rn(2, 1, 3 * D)
    one = (qkv1[..., :D], qkv1[..., D:2 * D], qkv1[..., 2 * D:], H, key_bias(2, 1), *g64)
    q127, k129, v129 = rn(2, H, 127, Dh), rn(2, H, 129, Dh), rn(2, H, 129, Dh)
    rows127 = torch.randn(2, 1, 127, 129, generator=gen, device=dev)
    rows127[:, :, 5] = torch.finfo(torch.float32).min
    masked = torch.full((2, 1, 1, 127), torch.finfo(torch.float32).min, device=dev)
    long_qkv = (rn(2, 1100, 3 * D)[..., :D], rn(2, 1300, 3 * D)[..., D:2 * D],
                rn(2, 1300, 3 * D)[..., 2 * D:])
    ql, kl, vl = rn(1, H, 1100, Dh), rn(1, H, 1200, Dh), rn(1, H, 1200, Dh)
    full_l = torch.randn(1, H, 1100, 1200, generator=gen, device=dev)
    variants = [
        ("ln_matmul, LN bias + bias, 1000 rows",
         lambda: fm.ln_matmul(xr, gamma, beta, w_qkv, b_qkv),
         lambda: fm.ln_matmul_plain(xr, gamma, beta, w_qkv, b_qkv)),
        ("ln_mlp, exact GELU + biases, hidden 3072, 1000 rows",
         lambda: fm.ln_mlp(xr, gamma, beta, wg1, bg1, wg2, bg2),
         lambda: fm.ln_mlp_plain(xr, gamma, beta, wg1, bg1, wg2, bg2)),
        ("flash_mha, no QK-norm, softmax1, N=M=300",
         lambda: at.flash_mha(*mha, allow_zero_attn=True),
         lambda: at.flash_mha_plain(*mha, allow_zero_attn=True)),
        ("attention, (B, H, N, M) bias, softmax1, N=100, M=333",
         lambda: at.attention(q, k, v, full, True),
         lambda: at.attention_plain(q, k, v, full, True)),
        ("flash_mha, QK-norm, N=5, M=7", lambda: at.flash_mha(*tiny),
         lambda: at.flash_mha_plain(*tiny)),
        ("flash_mha, QK-norm, N=M=1", lambda: at.flash_mha(*one), lambda: at.flash_mha_plain(*one)),
        ("attention, (B, 1, N, M) bias with query row 5 fully masked, N=127, M=129",
         lambda: at.attention(q127, k129, v129, rows127),
         lambda: at.attention_plain(q127, k129, v129, rows127)),
        ("attention, softmax1, every key masked, N=129, M=127",
         lambda: at.attention(k129, q127, q127, masked, True),
         lambda: at.attention_plain(k129, q127, q127, masked, True)),
        # past N = 1024 the kernel takes its long shape (128-query tiles)
        ("flash_mha, no QK-norm, no bias, N=1100, M=1300 (long shape)",
         lambda: at.flash_mha(*long_qkv, H), lambda: at.flash_mha_plain(*long_qkv, H)),
        ("attention, (B, H, N, M) bias, softmax1, N=1100, M=1200 (long shape)",
         lambda: at.attention(ql, kl, vl, full_l, True),
         lambda: at.attention_plain(ql, kl, vl, full_l, True)),
        ("ln_matmul, 3 rows", lambda: fm.ln_matmul(x[:3], gamma, None, w_qkv),
         lambda: fm.ln_matmul_plain(x[:3], gamma, None, w_qkv)),
    ]
    hold_variants(torch, variants + decode_variants)
    decode_edge_variants(torch, rn, gen, key_bias)
    return results


def decode_edge_variants(torch, rn, gen, key_bias) -> None:
    """self_decode and residual_mlp at the edges of their tile plans, at 4M-B
    width, with their planted faults: B = 1, 17 and 65 (one past the largest
    N tile: a second pass over the weights); then, for correctness only,
    self_decode at L = 32 and 33 (one attention warp, then two) and 1100
    (sixteen warps of two or three 32-position chunks)."""
    def hold(name, c, faults=True):
        parts = held(torch, name, c.get("held_run", c["run"]), c.get("held_plain", c["plain"]),
                     c.get("faults") if faults else None)
        print(f"variant {name}: " + "; ".join(
            f"{'' if p == 'out' else p + ' '}max_abs_err {e:.6g} (tol {t:.6g})"
            for p, (e, t) in parts.items()), flush=True)

    for B in (1, 17, 65):
        mk = decode_makers(torch, rn, gen, key_bias, B, 768, 2048, 256)
        hold(f"self_decode, B={B}, step 200", mk.self_case(200))
        hold(f"residual_mlp, B={B}", mk.mlp_case(B))
        del mk
    for L in (32, 33, 1100):
        mk = decode_makers(torch, rn, gen, key_bias, 3, 768, 2048, L)
        hold(f"self_decode, B=3, L={L}, step {L - 1}", mk.self_case(L - 1), faults=False)
        del mk
    torch.cuda.empty_cache()


def fault_check(torch, name, faults, refs, tols) -> None:
    """`faults()` gives (right, wrong, must): the right output recomputed
    in fp32 by the same means as the wrong ones, and named wrong outputs,
    each one tensor (the first part) or a dict of parts. The right one must
    sit within each part's tolerance of the twin (so the recomputation is
    sound); each wrong one named in `must` must sit farther than the
    tolerance in some part. The others are printed: faults below two bf16
    ulps of the output."""
    right, wrong, must = faults()
    first = next(iter(refs))

    def parts(out):
        return out if isinstance(out, dict) else {first: out}

    for part, out in parts(right).items():
        err = (out - refs[part]).abs().max().item()
        check(err <= tols[part], f"{name}: the faults' right {part} is {err} from the twin "
                                 f"(tol {tols[part]})")
    for label, out in wrong.items():
        dist = {p: (o - refs[p]).abs().max().item() for p, o in parts(out).items()}
        part = max(dist, key=lambda p: dist[p] / tols[p])
        d, tol = dist[part], tols[part]
        seen = d > tol
        where = "" if part == first else f" in {part}"
        print(f"  fault {label}: {d:.6g} from the twin{where}, {d / tol:.4g} x tol "
              f"({'caught' if seen else 'not caught: below two bf16 ulps'})", flush=True)
        check(seen or label not in must, f"{name}: tolerance {tol} cannot tell '{label}' ({d})")


def key_tile(N: int) -> int:
    """Keys per K/V tile of csrc/attention.cu's stage ring for N queries: 64
    in its short shape (N <= 1024), else 128."""
    return 64 if N <= 1024 else 128


def key_tile_faults(run, k, v, bias, axis: int, tile: int) -> dict:
    """Wrong outputs of an attention whose M keys lie along `axis` of k and v
    (and along the last axis of its bias), run(k, v, bias) being the twin:
    the last key tile of csrc/attention.cu (`tile` keys, or the ragged rest)
    left out; at M >= 4 tiles, every V tile from the third on read from two
    tiles back, as a stage ring that wraps onto a stale tile would."""
    M = k.shape[axis]
    keep = (M - 1) // tile * tile

    def cut(t, ax):
        return None if t is None else t.narrow(ax, 0, keep)

    wrong = {f"the last key tile ({M - keep} keys) left out":
             run(cut(k, axis), cut(v, axis), cut(bias, -1))}
    tiles = -(-M // tile)
    if tiles >= 4:
        stale = v.clone()
        for j in range(2, tiles):
            n = min(tile, M - j * tile)
            stale.narrow(axis, j * tile, n).copy_(v.narrow(axis, (j - 2) * tile, n))
        wrong["each V tile from the third on read from two tiles back (a stale ring "
              "stage)"] = run(k, stale, bias)
    return wrong


def mha_faults(q, k, v, H: int, bias=None, norms=(None,) * 4):
    """The faults of flash_mha / mha_short on (B, N|M, C) q, k, v slices with
    an fp32 (B, M) key bias and QK-norm's LN parameters (or none):
    key_tile_faults, and with QK-norm, K not normalised."""
    from fourm_torch.kernels import attention as at
    from fourm_torch.kernels.fused_mlp import layer_norm_fp32

    def run(kk, vv, bb):
        return at.flash_mha_plain(q, kk, vv, H, bb, *norms).float()

    wrong = key_tile_faults(run, k, v, bias, 1, key_tile(q.shape[1]))
    if norms[0] is not None:
        B, N, C = q.shape

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], H, C // H).transpose(1, 2)

        qn = layer_norm_fp32(heads(q).float(), norms[0], norms[1], 1e-6).to(q.dtype)
        raw = at.attention_plain(qn, heads(k), heads(v),
                                 None if bias is None else bias.float()[:, None, None, :])
        wrong["K not normalised"] = raw.transpose(1, 2).reshape(B, N, C).float()
    return run(k, v, bias), wrong, set(wrong)


def attention_faults(q, k, v, bias):
    """The faults of attention on (B, H, N|M, 64) q, k, v with an fp32 bias:
    key_tile_faults, and, for a per-query-row bias, each row's bias taken
    from the next query row."""
    from fourm_torch.kernels import attention as at

    def run(kk, vv, bb):
        return at.attention_plain(q, kk, vv, bb).float()

    wrong = key_tile_faults(run, k, v, bias, 2, key_tile(q.shape[2]))
    if bias is not None and bias.shape[2] > 1:
        wrong["the bias of the next query row"] = run(k, v, bias.roll(-1, dims=2))
    return run(k, v, bias), wrong, set(wrong)


def decode_makers(torch, rn, gen, key_bias, B=8, C=768, HID=2048, L=256, w2_tail_gain=1.0):
    """Builders of the decode-step kernels' cases at batch B and width C
    (H = C / 64 heads, 4M-21's QK-norm without biases, SwiGLU hidden HID,
    caches of L): self_case(step), cross_case(M), attn_case(M),
    mlp_case(rows), and the tensors the options off the path reuse.
    w2_tail_gain scales W2's last 16 columns, so that a kernel losing the
    ragged tail of W2's rows is told apart from the twin."""
    import types

    import torch.nn.functional as F

    from fourm_torch.kernels import decode_step as ds
    from fourm_torch.ops.transformer import rows_padded

    dev, bf = "cuda", torch.bfloat16
    H, Dh = C // 64, 64
    w = f"{C}"

    def norm(n):
        return (torch.rand(n, generator=gen, device=dev) + 0.5).to(bf)

    def shift(n):
        return (torch.randn(n, generator=gen, device=dev) * 0.1).to(bf)

    x = rn(B, C)
    g1, w_qkv, w_q = norm(C), rn(3 * C, C, std=C ** -0.5), rn(C, C, std=C ** -0.5)
    qk = [norm(Dh), None, norm(Dh), None]  # 4M-21: QK-norm without biases
    cache_k, cache_v = rn(B, H, L, Dh), rn(B, H, L, Dh)

    def lib_qkv_attn(xx, wt, kk, vv, bias=None):
        h = F.layer_norm(xx, (C,), g1, None, 1e-6)
        q = F.linear(h, wt)[:, :C].reshape(xx.shape[0], H, 1, Dh)
        return F.scaled_dot_product_attention(q, kk, vv, attn_mask=bias)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sd_plan = ds.self_decode_plan(B, C, L, sms)["qkv"]

    def stale_stage(wt, plan):
        """wt (rows, K) of a single product as a ring that wraps onto a
        stale stage reads it: each CTA's K block i from its ring's stage
        count on is block i - stages of its range (None where no CTA has
        more blocks than stages)."""
        stages = min(plan["kpb"], ds.GEMV_RING)
        if plan["kpb"] <= stages:
            return None
        out, tk = wt.clone(), ds.GEMV_TK
        for r in range(plan["split"]):
            for i in range(stages, plan["kpb"]):
                blk = r * plan["kpb"] + i
                if blk * tk >= wt.shape[1]:
                    break
                hi = min((blk + 1) * tk, wt.shape[1])
                out[:, blk * tk:hi] = wt[:, (blk - stages) * tk:hi - stages * tk]
        return out

    def last_rank_cut(wt, plan):
        """wt (rows, K) with the K blocks of the last rank of each cluster
        zeroed: a split-K partial left out."""
        out = wt.clone()
        out[:, (plan["split"] - 1) * plan["kpb"] * ds.GEMV_TK:] = 0
        return out

    def self_faults(step):
        """self_decode's output and the cache rows it writes, recomputed
        from the untouched caches, and wrong versions of them: the new token
        left out, one cache position too many or too few read, q not rounded
        to bf16 before the logits, the new k/v row not written, the keys of
        a cache tile (a warp's chunk of 32 positions) left out, a split-K
        partial of the projection left out, a stale weight stage."""
        h = F.layer_norm(x.float(), (C,), g1.float(), None, 1e-6).to(bf).float()
        krow, vrow = f"k row {step}", f"v row {step}"

        def project(wt):
            q, k, v = (h @ wt.float().t()).reshape(B, 3, H, Dh).unbind(1)
            q = F.layer_norm(q, (Dh,), qk[0].float(), None, 1e-6)
            k = F.layer_norm(k, (Dh,), qk[2].float(), None, 1e-6)
            return q, *(t.to(bf).float() for t in (q, k, v))

        q, qb, k, v = project(w_qkv)

        def attend(qq, n, new=True, kk=k, vv=v, skip=None):
            keys = torch.cat([cache_k[:, :, :n].float()] + [kk[:, :, None]] * new, 2)
            vals = torch.cat([cache_v[:, :, :n].float()] + [vv[:, :, None]] * new, 2)
            s_ = torch.einsum("bhd,bhld->bhl", qq, keys) * Dh ** -0.5
            if skip is not None:
                s_[:, :, skip] = float("-inf")
            p = torch.softmax(s_, -1)
            return torch.einsum("bhl,bhld->bhd", p, vals).reshape(B, C)

        def with_rows(out, kk=k, vv=v):
            return {"out": out, krow: kk, vrow: vv}

        wrong = {"one cache position too many read": attend(qb, step + 1)}
        if step:  # at step 0 the output is the new v, whatever q is
            wrong["new token left out"] = attend(qb, step, new=False)
            wrong["one cache position too few read"] = attend(qb, step - 1)
            wrong["q not rounded to bf16"] = attend(q, step)
        right = attend(qb, step)
        if step < L:
            wrong["the new k/v row not written"] = with_rows(
                right, cache_k[:, :, step].float(), cache_v[:, :, step].float())
        if step > 2 * ds.CACHE_CHUNK:
            wrong["the keys of cache tile 1 left out"] = attend(
                qb, step, skip=slice(ds.CACHE_CHUNK, 2 * ds.CACHE_CHUNK))
        if sd_plan["split"] > 1:
            _, qc, kc, vc = project(last_rank_cut(w_qkv, sd_plan))
            wrong["a split-K partial of Wqkv left out"] = with_rows(attend(qc, step, kk=kc, vv=vc),
                                                                   kc, vc)
        stale = stale_stage(w_qkv, sd_plan)
        if stale is not None:
            _, qs, ks, vs = project(stale)
            wrong["a stale Wqkv stage"] = with_rows(attend(qs, step, kk=ks, vv=vs), ks, vs)
        if B > ds.GEMV_N_TILES[-1]:  # the rows of the projection's second pass
            n1 = ds.GEMV_N_TILES[-1]
            cut = [t.clone() for t in (right, cache_k[:, :, min(step, L - 1)].float(),
                                       cache_v[:, :, min(step, L - 1)].float())]
            cut[0][n1:] = 0
            wrong["token rows past the first N tile left out"] = with_rows(
                cut[0], torch.cat([k[:n1], cut[1][n1:]]), torch.cat([v[:n1], cut[2][n1:]]))
        return right, wrong, set(wrong) - {"q not rounded to bf16"}

    def self_case(step):
        caches = [(cache_k.clone(), cache_v.clone()) for _ in range(2)]
        st = torch.tensor([step], dtype=torch.int32, device=dev)

        def call(fn, i):  # the output and the two cache rows it wrote, held apart
            ck, cv = caches[i]
            out = fn(x, g1, None, w_qkv, None, *qk, ck, cv, st, H)
            return {"out": out, f"k row {step}": ck[:, :, step], f"v row {step}": cv[:, :, step]}

        def cold():  # copies of Wqkv and the caches
            runs, libs = [], []
            for _ in range(cold_copies((3 * C * C + 2 * cache_k.numel()) * 2)):
                wc, kc, vc = w_qkv.clone(), cache_k.clone(), cache_v.clone()
                runs.append(lambda wc=wc, kc=kc, vc=vc: ds.self_decode(
                    x, g1, None, wc, None, *qk, kc, vc, st, H))
                libs.append(lambda wc=wc, kc=kc, vc=vc: lib_qkv_attn(x, wc, kc[:, :, kv],
                                                                     vc[:, :, kv]))
            return runs, libs

        ck0, cv0 = caches[0]
        kv = slice(0, step + 1)
        return dict(
            run=lambda: ds.self_decode(x, g1, None, w_qkv, None, *qk, ck0, cv0, st, H),
            plain=lambda: ds.self_decode_plain(x, g1, None, w_qkv, None, *qk, *caches[1], st, H),
            held_run=lambda: call(ds.self_decode, 0),
            held_plain=lambda: call(ds.self_decode_plain, 1),
            faults=lambda: self_faults(step), cold=cold,
            library=lambda: lib_qkv_attn(x, w_qkv, ck0[:, :, kv], cv0[:, :, kv]),
            flops=2 * B * C * 3 * C + 4 * B * H * step * Dh,
            bytes=(3 * C * C + 2 * B * C) * 2 + 2 * B * H * (step + 1) * Dh * 2 + C * 2,
            shape=f"x (B={B}, {w}), w_qkv ({3 * C}, {w}), caches (B, {H}, L={L}, 64), "
                  f"step_idx {step}, QK-norm")

    def cross_kv(M, gain=None):
        kv = rn(B, M, 2, H, Dh)  # head views of one KV projection, read through strides
        if gain is not None:
            kv = kv * gain.to(bf)
        return kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)

    def kv_copy(k, v):
        """Copies of the cross K/V views k, v (of one (B, M, 2, H, 64) tensor)."""
        kv = torch.stack((k.transpose(1, 2), v.transpose(1, 2)), 2).contiguous()
        return kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)

    def split_faults(run, k, v, bias, int8=False):
        """Wrong outputs of csrc/decode_attn.cu's split plan
        (decode_attention_plan) on (B, H, M, 64) K/V and a (B, M) bias,
        run(k, v, bias) being the twin: the last split's keys left out; the
        last 64-key tile of the first split left out; every V tile of a split
        from its ring's stage count on read from that many tiles back (a stale
        stage), where a split has more tiles than stages."""
        M, tile = k.shape[2], ds.DECODE_TILE
        plan = ds.decode_attention_plan(B, H, M, int8, sms)
        keys, split, stages = plan["keys"], plan["split"], plan["stages"]

        def without(lo, hi):
            keep = torch.cat([torch.arange(0, lo), torch.arange(hi, M)]).to(dev)
            return run(k[:, :, keep], v[:, :, keep], None if bias is None else bias[:, keep])

        wrong = {}
        if split > 1:
            wrong[f"the last split (keys {(split - 1) * keys}-{M}) left out"] = without(
                (split - 1) * keys, M)
        last = min(keys, M)
        wrong[f"the first split's last 64-key tile (keys {(last - 1) // tile * tile}-{last}) "
              "left out"] = without((last - 1) // tile * tile, last)
        if keys // tile > stages:
            stale = v.clone()
            for r in range(split):
                for i in range(stages, keys // tile):
                    lo = r * keys + i * tile
                    if lo >= M:
                        break
                    n = min(tile, M - lo)
                    stale[:, :, lo:lo + n] = v[:, :, lo - stages * tile:lo - stages * tile + n]
            wrong[f"a stale V stage ({stages} stages, {keys // tile} tiles a split)"] = run(
                k, stale, bias)
        return wrong

    def cross_case(M):
        k, v = cross_kv(M)
        bias = key_bias(B, M, full_rows=1)
        args = (x, g1, None, w_q, None, qk[0], None, k, v, bias, H)
        mask = bias[:, None, None, :].to(bf)
        x_prev = rn(B, C)  # the token of the call before

        def faults():
            """The split plan's faults, and q taken from the previous call's
            token (a q read before the PDL wait)."""
            def run(kk, vv, bb):
                return ds.cross_decode_attn_plain(*args[:7], kk, vv, bb, H).float()

            wrong = split_faults(run, k, v, bias)
            wrong["q taken from the previous call"] = ds.cross_decode_attn_plain(
                x_prev, *args[1:]).float()
            return run(k, v, bias), wrong, set(wrong)

        def back_to_back():
            """The call right after one on another token: the attention
            kernel, launched under PDL, must read the q of its own call."""
            ds.cross_decode_attn(x_prev, *args[1:])
            return ds.cross_decode_attn(*args)

        def cold():  # copies of w_q and the cross K/V
            runs, libs = [], []
            for _ in range(cold_copies((C * C + 2 * k.numel()) * 2)):
                wc, (kc, vc) = w_q.clone(), kv_copy(k, v)
                runs.append(lambda wc=wc, kc=kc, vc=vc: ds.cross_decode_attn(
                    x, g1, None, wc, None, qk[0], None, kc, vc, bias, H))
                libs.append(lambda wc=wc, kc=kc, vc=vc: lib_qkv_attn(x, wc, kc, vc, mask))
            return runs, libs

        return dict(
            run=lambda: ds.cross_decode_attn(*args),
            plain=lambda: ds.cross_decode_attn_plain(*args), cold=cold,
            held_run=back_to_back, faults=faults,
            library=lambda: lib_qkv_attn(x, w_q, k, v, mask),
            flops=2 * B * C * C + 4 * B * H * M * Dh,
            bytes=(C * C + 2 * B * C) * 2 + 2 * B * H * M * Dh * 2 + B * M * 4 + C * 2,
            shape=f"x (B={B}, {w}), w_q ({w}, {w}), cross K/V (B, {H}, M={M}, 64) views, "
                  "(B, M) key bias, 1 row fully masked, QK-norm")

    def int8_case(M, with_bias=True):
        """cross_decode_attn's int8 mode over K/V whose channels differ in
        range (a gain in [0.5, 2] per head and channel, as projected keys
        do), quantized on the card; with the faults that a kernel missing
        the K scale, or applying the V scale of another head, would show."""
        gain = 0.5 + 1.5 * torch.rand(H, Dh, generator=gen, device=dev)
        k, v = cross_kv(M, gain)
        k8, ks, v8, vs = ds.quantize_kv_decode(k, v)
        bias = key_bias(B, M, full_rows=1) if with_bias else None
        args = (x, g1, None, w_q, None, qk[0], None, k8, v8, bias, H)

        def plain(k_scale=ks, v_scale=vs):
            return ds.cross_decode_attn_plain(*args, k_scale=k_scale, v_scale=v_scale)

        def faults():
            def run(kk, vv, bb):
                return ds.cross_decode_attn_plain(*args[:7], kk, vv, bb, H, k_scale=ks,
                                                  v_scale=vs).float()

            wrong = {"K scale not folded into q": plain(k_scale=torch.ones_like(ks)).float(),
                     "V scale of the heads reversed": plain(v_scale=vs.flip(1)).float(),
                     **split_faults(run, k8, v8, bias, int8=True)}
            return plain().float(), wrong, set(wrong)

        def library(wq=w_q, kq=k8, vq=v8):  # dequantize, then the bf16 yardstick
            kd, vd = (t.to(bf) * s[:, :, None, :].to(bf) for t, s in ((kq, ks), (vq, vs)))
            return lib_qkv_attn(x, wq, kd, vd,
                                None if bias is None else bias[:, None, None, :].to(bf))

        def oracle():
            """The relations JAX's tests hold the int8 mode to: the bf16
            kernel on the dequantized K/V, the unquantized K/V within 5%,
            and quantize_kv_decode equal to its CPU result."""
            out = ds.cross_decode_attn(*args, k_scale=ks, v_scale=vs).float()
            kd, vd = (t.float() * s[:, :, None, :] for t, s in ((k8, ks), (v8, vs)))
            deq = ds.cross_decode_attn(*args[:7], kd.to(bf), vd.to(bf), bias, H).float()
            ref = ds.cross_decode_attn(*args[:7], k, v, bias, H).float()
            torch.cuda.synchronize()
            tol = 2.0 ** -6 * deq.abs().max().item()
            err = (out - deq).abs().max().item()
            rel = (out - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
            cpu = ds.quantize_kv_decode(k.cpu(), v.cpu())
            same = all(torch.equal(a.cpu(), b) for a, b in zip((k8, ks, v8, vs), cpu))
            print(f"  int8 M={M}: against the bf16 kernel on the dequantized K/V max abs err "
                  f"{err:.6g} (tol {tol:.6g}); quantization error against the unquantized K/V "
                  f"{rel:.6g} relative (limit 0.05); quantize_kv_decode on the card equal to "
                  f"the CPU's: {same}", flush=True)
            check(err <= tol, f"int8 M={M}: {err} from the bf16 kernel on dequantized K/V")
            check(rel < 0.05, f"int8 M={M}: quantization error {rel} >= 0.05")
            check(same, f"int8 M={M}: quantize_kv_decode differs between the card and the CPU")

        def cold():  # copies of w_q and the int8 cross K/V
            runs, libs = [], []
            for _ in range(cold_copies(C * C * 2 + 2 * k8.numel())):
                wc, kc, vc = w_q.clone(), k8.clone(), v8.clone()
                runs.append(lambda wc=wc, kc=kc, vc=vc: ds.cross_decode_attn(
                    x, g1, None, wc, None, qk[0], None, kc, vc, bias, H, k_scale=ks, v_scale=vs))
                libs.append(lambda wc=wc, kc=kc, vc=vc: library(wc, kc, vc))
            return runs, libs

        return dict(
            run=lambda: ds.cross_decode_attn(*args, k_scale=ks, v_scale=vs), plain=plain,
            faults=faults, library=library, oracle=oracle, cold=cold,
            wrapper="decode_attention_int8", path="int8_chain",
            flops=2 * B * C * C + 4 * B * H * M * Dh,
            bytes=(C * C + 2 * B * C) * 2 + 2 * B * H * M * Dh + 2 * B * H * Dh * 4
            + (B * M * 4 if with_bias else 0) + C * 2,
            shape=f"int8 mode: x (B={B}, {w}), w_q ({w}, {w}), int8 cross K/V (B, {H}, "
                  f"M={M}, 64) with fp32 (B, {H}, 64) scales, "
                  + ("(B, M) key bias, 1 row fully masked" if with_bias else "no mask")
                  + ", QK-norm")

    def attn_case(M):
        k, v = cross_kv(M)
        q = rn(B, H, 1, Dh)
        bias = key_bias(B, M, full_rows=1)[:, None, :]
        args = (q, k, v, bias, False, False)  # the cross path: fp32 probabilities

        def faults():
            def run(kk, vv, bb):
                return ds.decode_attention_plain(q, kk, vv, bb[:, None], False, False).float()

            wrong = split_faults(run, k, v, bias[:, 0])
            return ds.decode_attention_plain(*args).float(), wrong, set(wrong)

        def cold():  # copies of the cross K/V
            runs, libs = [], []
            for _ in range(cold_copies(2 * k.numel() * 2)):
                kc, vc = kv_copy(k, v)
                runs.append(lambda kc=kc, vc=vc: ds.decode_attention(q, kc, vc, bias, False, False))
                libs.append(lambda kc=kc, vc=vc: F.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=bias[:, :, None, :].to(bf)))
            return runs, libs

        return dict(
            run=lambda: ds.decode_attention(*args), plain=lambda: ds.decode_attention_plain(*args),
            faults=faults, cold=cold,
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias[:, :, None, :]
                                                           .to(bf)),
            flops=4 * B * H * M * Dh, bytes=2 * B * H * M * Dh * 2 + 2 * B * H * Dh * 2 + B * M * 4,
            shape=f"q (B={B}, {H}, 1, 64), K/V (B, {H}, M={M}, 64) views, (B, 1, M) bias, "
                  "1 row fully masked, fp32 probabilities")

    wp, w1, w3, w2 = (rn(C, C, std=C ** -0.5), rn(HID, C, std=C ** -0.5),
                      rn(HID, C, std=C ** -0.5), rn(C, HID, std=HID ** -0.5))
    w2[:, -16:] *= w2_tail_gain
    w2 = rows_padded(w2)  # the layout the MLP modules keep fc2's weight in
    g2 = norm(C)
    HID8 = HID // 8 * 8  # the hidden units a 16-byte aligned read of W2's rows covers

    def mlp_case(rows):
        xx, attn = rn(rows, C), rn(rows, C)
        args = (xx, attn, wp, None, g2, None, w1, None, w2, None, w3, None)
        out_plan = ds.residual_mlp_plan(rows, C, HID, True, sms)["out"]

        def library(wp=wp, w1=w1, w3=w3, w2=w2):
            x1 = xx + F.linear(attn, wp)
            h = F.layer_norm(x1, (C,), g2, None, 1e-6)
            return x1 + F.linear(F.silu(F.linear(h, w1)) * F.linear(h, w3), w2)

        def plain_with(w2x):
            return ds.residual_mlp_plain(xx, attn, wp, None, g2, None, w1, None, w2x, None, w3,
                                         None, gated=True).float()

        def faults():
            """Wrong outputs: W2's columns past the last multiple of 8 left
            out; the partial of the last rank of each cluster of fc2 left
            out; a stale W2 stage."""
            wrong = {}
            if HID8 < HID:
                cut = (xx, attn, wp, None, g2, None, w1[:HID8], None, w2[:, :HID8].contiguous(),
                       None, w3[:HID8], None)
                wrong["W2's tail columns left out"] = ds.residual_mlp_plain(
                    *cut, gated=True).float()
            if out_plan["split"] > 1:
                wrong["a split-K partial of W2 left out"] = plain_with(last_rank_cut(w2, out_plan))
            stale = stale_stage(w2, out_plan)
            if stale is not None:
                wrong["a stale W2 stage"] = plain_with(stale)
            right = ds.residual_mlp_plain(*args, gated=True).float()
            if rows > ds.GEMV_N_TILES[-1]:  # the rows of the second pass
                wrong["token rows past the first N tile left out"] = right.clone()
                wrong["token rows past the first N tile left out"][ds.GEMV_N_TILES[-1]:] = 0
            return right, wrong, set(wrong)

        def cold():  # copies of the four weights
            runs, libs = [], []
            for _ in range(cold_copies((C * C + 3 * C * HID) * 2)):
                ws = [t.clone() for t in (wp, w1, w3)] + [rows_padded(w2)]
                runs.append(lambda ws=ws: ds.residual_mlp(xx, attn, ws[0], None, g2, None, ws[1],
                                                          None, ws[3], None, ws[2], None,
                                                          gated=True))
                libs.append(lambda ws=ws: library(*ws))
            return runs, libs

        return dict(
            run=lambda: ds.residual_mlp(*args, gated=True),
            plain=lambda: ds.residual_mlp_plain(*args, gated=True), library=library,
            faults=faults, cold=cold,
            flops=2 * rows * (C * C + 3 * C * HID),
            bytes=(C * C + 3 * C * HID + 3 * rows * C) * 2 + C * 2,
            shape=f"x, attn (B={rows}, {w}), Wp ({w}, {w}), SwiGLU hidden {HID}, no biases")

    return types.SimpleNamespace(
        x=x, g1=g1, w_q=w_q, w_qkv=w_qkv, wp=wp, g2=g2, cache_k=cache_k, cache_v=cache_v,
        norm=norm, shift=shift, cross_kv=cross_kv, self_case=self_case, cross_case=cross_case,
        int8_case=int8_case, attn_case=attn_case, mlp_case=mlp_case)


def decode_kernel_cases(torch, rn, key_bias, gen):
    """The decode-step kernels at the AR part's shapes (B = 8 requests, no
    CFG; caches L = 256; cross K/V at the encoder budget M = 2048 and at a
    ragged whole-stream M), and their options off the path."""
    from fourm_torch.kernels import decode_step as ds

    dev = "cuda"
    B, C, H, Dh, L = 8, 768, 12, 64, 256
    mk = decode_makers(torch, rn, gen, key_bias, B, C, 2048, L)
    x, g1, w_q, w_qkv, wp, g2 = mk.x, mk.g1, mk.w_q, mk.w_qkv, mk.wp, mk.g2
    cache_k, cache_v, norm, shift, cross_kv = mk.cache_k, mk.cache_v, mk.norm, mk.shift, mk.cross_kv
    self_case, cross_case, attn_case, mlp_case = mk.self_case, mk.cross_case, mk.attn_case, \
        mk.mlp_case
    sd_src = "fourm_torch/kernels/csrc/self_decode.cu"
    da_src = "fourm_torch/kernels/csrc/decode_attn.cu"

    cases = [
        ("self_decode", "fourm_tpu/kernels/decode_step.py:163", sd_src, self_case(200)),
        ("self_decode@step0", "fourm_tpu/kernels/decode_step.py:163", sd_src, self_case(0)),
        ("cross_decode_attn", "fourm_tpu/kernels/decode_step.py:377", da_src, cross_case(2048)),
        ("cross_decode_attn@M2900", "fourm_tpu/kernels/decode_step.py:377", da_src,
         cross_case(2900)),
        ("decode_attention", "fourm_tpu/kernels/decode_step.py:594", da_src, attn_case(2048)),
        ("decode_attention@M2900", "fourm_tpu/kernels/decode_step.py:594", da_src,
         attn_case(2900)),
        ("residual_mlp", "fourm_tpu/kernels/decode_step.py:752",
         "fourm_torch/kernels/csrc/residual_mlp.cu", mlp_case(8)),
        ("residual_mlp@B16", "fourm_tpu/kernels/decode_step.py:752",
         "fourm_torch/kernels/csrc/residual_mlp.cu", mlp_case(16)),
    ]

    # options the main path does not take: correctness only
    b1, bq = shift(C), shift(3 * C)
    qkb = [norm(Dh), shift(Dh), norm(Dh), shift(Dh)]
    c2 = [(cache_k.clone(), cache_v.clone()) for _ in range(2)]
    st = torch.tensor([100], dtype=torch.int32, device=dev)
    st_past = torch.tensor([L + 3], dtype=torch.int32, device=dev)
    k3, v3 = cross_kv(333)
    q3 = rn(5, H, 1, Dh)
    bias_h = torch.randn(5, H, 333, generator=gen, device=dev)
    k5, v5 = k3[:5], v3[:5]
    wg1, wg2 = rn(3072, C, std=C ** -0.5), rn(C, 3072, std=3072 ** -0.5)
    bg1, bg2 = shift(3072), shift(C)
    x3, a3 = rn(3, C), rn(3, C)

    def sd(fn, i, step_t, qkn=(None,) * 4, **kw):
        return lambda: fn(x, g1, b1, w_qkv, bq, *qkn, *c2[i], step_t, H, **kw)

    variants = [
        ("self_decode, biases, no QK-norm, softmax1, step 100",
         sd(ds.self_decode, 0, st, allow_zero_attn=True),
         sd(ds.self_decode_plain, 1, st, allow_zero_attn=True)),
        ("self_decode, QK-norm with biases, step_idx past L (no write, all L attended)",
         sd(ds.self_decode, 0, st_past, qkn=qkb), sd(ds.self_decode_plain, 1, st_past, qkn=qkb)),
        ("cross_decode_attn, biases, no QK-norm, softmax1, no mask, M=333",
         lambda: ds.cross_decode_attn(x[:5], g1, b1, w_q, b1, None, None, k5, v5, None, H,
                                      allow_zero_attn=True),
         lambda: ds.cross_decode_attn_plain(x[:5], g1, b1, w_q, b1, None, None, k5, v5, None, H,
                                            allow_zero_attn=True)),
        ("decode_attention, (B, H, M) bias, softmax1, probabilities cast to bf16, M=333",
         lambda: ds.decode_attention(q3, k5, v5, bias_h, True),
         lambda: ds.decode_attention_plain(q3, k5, v5, bias_h, True)),
        ("residual_mlp, exact GELU + biases, hidden 3072, 3 rows",
         lambda: ds.residual_mlp(x3, a3, wp, b1, g2, b1, wg1, bg1, wg2, bg2),
         lambda: ds.residual_mlp_plain(x3, a3, wp, b1, g2, b1, wg1, bg1, wg2, bg2)),
    ]
    return cases, variants


def xl_kernel_phase(torch, card: str):
    """Phase 2b: the kernels at the widths of 4M-21 XL (D = 2048, 32 heads,
    SwiGLU hidden 5461) and 4M-L (D = 1024, hidden 2730) against their twins,
    as phase 2: the XL chain's rows (4 requests, 8 with CFG, at a 2304-token
    encoder budget; decode steps at B = 4 and 8, M = 2304), and the int8 mode
    of cross_decode_attn at 4M-B (B = 16, M = 2304, the decode
    microbenchmark's shape) and at XL, with and without a key bias; ln_matmul
    and ln_mlp also at the XL decoder grid (8 x 196 rows). Faults the
    tolerance must catch: ln_mlp's ragged tail tile and the W2 tail columns
    its wrapper pads (at 8x the lecun scale), and W2's tail columns in
    residual_mlp, left out; the K scale not folded, the V scale of the heads
    reversed."""
    import torch.nn.functional as F

    from fourm_torch.kernels import attention as at

    gen, rn, key_bias = random_makers(torch, 4)
    dev, bf = "cuda", torch.bfloat16
    rows, M = 8 * 2304, 2304
    fa = "fourm_torch/kernels/csrc/attention.cu"
    da = "fourm_torch/kernels/csrc/decode_attn.cu"
    sd = "fourm_torch/kernels/csrc/self_decode.cu"
    rm = "fourm_torch/kernels/csrc/residual_mlp.cu"
    lmm, slm = "fourm_tpu/kernels/fused_mlp.py:181", "fourm_torch/kernels/csrc/ln_matmul.cu"
    lml, sml = "fourm_tpu/kernels/fused_mlp.py:244", "fourm_torch/kernels/csrc/ln_mlp.cu"

    def flash_case(B, N):
        D, H, Dh = 2048, 32, 64
        qkv = rn(B, N, 3 * D)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        bias = key_bias(B, N, full_rows=1)
        g64 = [torch.rand(64, generator=gen, device=dev) + 0.5,
               torch.randn(64, generator=gen, device=dev) * 0.1] * 2
        args = (q, k, v, H, bias, *g64)
        qn = F.layer_norm(q.reshape(B, N, H, Dh).float(), (Dh,), g64[0], g64[1], 1e-6)
        kn = F.layer_norm(k.reshape(B, N, H, Dh).float(), (Dh,), g64[2], g64[3], 1e-6)
        qn, kn = qn.to(bf).transpose(1, 2), kn.to(bf).transpose(1, 2)
        vh, mask = v.reshape(B, N, H, Dh).transpose(1, 2), bias[:, None, None, :].to(bf)
        return dict(
            run=lambda: at.flash_mha(*args), plain=lambda: at.flash_mha_plain(*args),
            library=lambda: F.scaled_dot_product_attention(qn, kn, vh, attn_mask=mask),
            faults=lambda: mha_faults(q, k, v, H, bias, g64),
            flops=4 * B * H * N * N * Dh, bytes=4 * B * N * D * 2 + B * N * 4, path="xl_chain",
            shape=f"q,k,v (B={B}, N=M={N}, C=2048) slices of QKV, 32 heads, QK-norm, key bias")

    def attn_case(B, N, M_):
        H, Dh = 32, 64
        q, k, v = rn(B, H, N, Dh), rn(B, H, M_, Dh), rn(B, H, M_, Dh)
        bias = key_bias(B, M_)[:, None, None, :]
        return dict(
            run=lambda: at.attention(q, k, v, bias),
            plain=lambda: at.attention_plain(q, k, v, bias),
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(bf)),
            faults=lambda: attention_faults(q, k, v, bias),
            flops=4 * B * H * N * M_ * Dh,
            bytes=(2 * B * H * N * Dh + 2 * B * H * M_ * Dh) * 2 + B * M_ * 4, path="xl_chain",
            shape=f"q (B={B}, 32, N={N}, 64), k/v M={M_}, (B, 1, 1, M) bias")

    def xl(case):
        return dict(case, path="xl_chain")

    xl4 = decode_makers(torch, rn, gen, key_bias, 4, 2048, 5461, w2_tail_gain=8.0)
    xl8 = decode_makers(torch, rn, gen, key_bias, 8, 2048, 5461)
    large = decode_makers(torch, rn, gen, key_bias, 4, 1024, 2730, w2_tail_gain=8.0)
    base16 = decode_makers(torch, rn, gen, key_bias, 16, 768, 2048)
    cases = [
        ("ln_matmul@XL", lmm, slm, ln_matmul_row(torch, rn, gen, rows, 2048, 6144,
                                                 path="xl_chain")),
        ("ln_matmul@XL_N196", lmm, slm, ln_matmul_row(torch, rn, gen, 8 * 196, 2048, 6144,
                                                      path="xl_chain")),
        ("ln_mlp@XL", lml, sml, ln_mlp_row(torch, rn, gen, rows, 2048, 5461, True,
                                           path="xl_chain", w2_tail_gain=8.0)),
        ("ln_mlp@XL_N196", lml, sml, ln_mlp_row(torch, rn, gen, 8 * 196, 2048, 5461, True,
                                                path="xl_chain", w2_tail_gain=8.0)),
        ("ln_mlp@L", lml, sml, ln_mlp_row(torch, rn, gen, rows, 1024, 2730, True,
                                          path="sr_chain", w2_tail_gain=8.0)),
        ("flash_mha@XL", "fourm_tpu/kernels/attention.py:587", fa, flash_case(8, 2304)),
        ("flash_mha@XL_N196", "fourm_tpu/kernels/attention.py:587", fa, flash_case(8, 196)),
        ("attention@XL", "fourm_tpu/kernels/attention.py:325", fa, attn_case(8, 196, 2304)),
        ("attention@XL_M2900", "fourm_tpu/kernels/attention.py:325", fa, attn_case(8, 196, 2900)),
        ("self_decode@XL_B4", "fourm_tpu/kernels/decode_step.py:163", sd, xl(xl4.self_case(200))),
        ("self_decode@XL_B8", "fourm_tpu/kernels/decode_step.py:163", sd, xl(xl8.self_case(200))),
        ("cross_decode_attn@XL_B4", "fourm_tpu/kernels/decode_step.py:377", da,
         xl(xl4.cross_case(M))),
        ("cross_decode_attn@XL_B8", "fourm_tpu/kernels/decode_step.py:377", da,
         xl(xl8.cross_case(M))),
        ("decode_attention@XL_B4", "fourm_tpu/kernels/decode_step.py:594", da,
         xl(xl4.attn_case(M))),
        ("decode_attention@XL_B8", "fourm_tpu/kernels/decode_step.py:594", da,
         xl(xl8.attn_case(M))),
        ("residual_mlp@XL", "fourm_tpu/kernels/decode_step.py:752", rm, xl(xl4.mlp_case(4))),
        ("residual_mlp@L", "fourm_tpu/kernels/decode_step.py:752", rm, xl(large.mlp_case(4))),
        ("cross_decode_attn@int8", "fourm_tpu/kernels/decode_step.py:377", da,
         base16.int8_case(M)),
        ("cross_decode_attn@int8_nobias", "fourm_tpu/kernels/decode_step.py:377", da,
         base16.int8_case(M, with_bias=False)),
        ("cross_decode_attn@int8_XL", "fourm_tpu/kernels/decode_step.py:377", da,
         xl4.int8_case(M)),
    ]
    results = time_cases(torch, cases, card)
    w2_update_check(torch)
    for name, _r, _s, c in cases:  # the redesigned decode kernels: two runs, bit for bit
        if name.split("@")[0] in ("self_decode", "residual_mlp", "cross_decode_attn",
                                  "decode_attention"):
            a, b = c["run"](), c["run"]()
            torch.cuda.synchronize()
            print(f"bit-identical {name}: two runs {'equal' if torch.equal(a, b) else 'DIFFER'}",
                  flush=True)
            check(torch.equal(a, b), f"{name}: two runs differ")
    return results


def adversarial_codebooks(torch, gen, N: int, D: int, dev) -> dict:
    """Codebooks built against the search's TF32 screen, each with N query
    rows (fp32, from `gen`): name -> (x (N, D), codebook (K, D)).
    tf32_collisions: groups of 8 codes that share their TF32 bits (the top
    19 of each fp32 value): the group's base with its low 13 bits zero, 5
    with random low bits, 1 with all low bits set (the exact winner), and 1
    with one coordinate a TF32 ulp larger and no low bits (the winner of a
    truncating screen that keeps only its max, in cosine form; in the
    Euclidean form the base is); each row is a group's all-ones code.
    near_ties: groups of 5: a base and copies with one
    coordinate 1-4 fp32 ulps larger in magnitude, in shuffled places; rows
    are bases. duplicates: each code 4 times, in shuffled places; rows near
    codes. small_K: 50 codes, fewer than one 128-code tile. Cosine inputs
    are l2-normalised before the bits are set."""
    import torch.nn.functional as F

    def unit(n):
        return F.normalize(torch.randn(n, D, generator=gen, device=dev), dim=-1)

    def bits(t):
        return t.contiguous().view(torch.int32)

    def pick(n, k):
        return torch.randint(0, k, (n,), generator=gen, device=dev)

    out = {}
    groups = 2048
    base = bits(unit(groups)) & ~0x1FFF
    low = torch.randint(0, 0x2000, (groups, 5, D), generator=gen, device=dev, dtype=torch.int32)
    bump = base.clone()
    j = pick(groups, D)
    bump[torch.arange(groups, device=dev), j] += 0x2000
    codes = torch.cat([base[:, None], base[:, None] | low, (base | 0x1FFF)[:, None],
                       bump[:, None]], dim=1)
    e = codes.view(torch.float32).reshape(-1, D)
    out["tf32_collisions"] = ((base | 0x1FFF).view(torch.float32)[pick(N, groups)], e)

    groups = 3000
    base = unit(groups)
    near = base[:, None].repeat(1, 5, 1)
    j = pick(groups, D)
    for k in range(1, 5):
        b = bits(near[:, k])
        b[torch.arange(groups, device=dev), j] += k  # k ulps larger in magnitude
        near[:, k] = b.view(torch.float32)
    e = near.reshape(-1, D)[torch.randperm(groups * 5, generator=gen, device=dev)]
    out["near_ties"] = (base[pick(N, groups)], e)

    base = unit(4096)
    e = base.repeat(4, 1)[torch.randperm(4 * 4096, generator=gen, device=dev)]
    x = F.normalize(base[pick(N, 4096)] + 0.05 * torch.randn(N, D, generator=gen, device=dev),
                    dim=-1)
    out["duplicates"] = (x, e)
    out["small_K"] = (unit(N), unit(50))
    return out


def _search_values(torch, x, e, cosine, rows):
    """The twins' values of rows `rows` of x against every code (fp32: the
    dot products, or the Euclidean value), by the twins' own arithmetic."""
    from fourm_torch.kernels import vq_codebook as vc

    dots = vc._dots(x[rows], e)
    if cosine:
        return dots
    return -((vc._sq_norms(x[rows])[:, None] - 2.0 * dots) + vc._sq_norms(e)[None, :])


def _row_chunks(x, e):
    step = max(1, (1 << 24) // e.shape[0])
    return [slice(i, i + step) for i in range(0, x.shape[0], step)]


def zero_margin_search(torch, x, e, cosine):
    """The planted fault of a screen without its margin: TF32 operands
    truncated, products summed in fp32, only the codes at the row's screen
    max rescored (exactly; the first index on ties among them)."""
    def tf32(t):
        return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)

    from fourm_torch.kernels import vq_codebook as vc

    xt, et = tf32(x), tf32(e)
    out = []
    for rows in _row_chunks(x, e):
        acc = vc._dots(xt[rows], et)  # TF32 products are exact in fp32
        if not cosine:
            acc = 2.0 * acc - vc._sq_norms(e)[None, :]
        keep = acc >= acc.max(dim=1, keepdim=True).values
        vals = _search_values(torch, x, e, cosine, rows)
        out.append(torch.where(keep, vals, torch.tensor(-float("inf"), device=x.device))
                   .argmax(dim=1))
    return torch.cat(out)


def search_faults(torch, x, e, cosine, which) -> dict:
    """Wrong indices a search could give, from the twins' values: the
    second-best code, the last index on ties, the codes of tile 1 (128..255)
    left out, the ragged last tile (codes past the last multiple of 128)
    dropped; `which` names those wanted."""
    tile = 128
    K = e.shape[0]
    out = {w: [] for w in which}
    ninf = torch.tensor(-float("inf"), device=x.device)
    for rows in _row_chunks(x, e):
        v = _search_values(torch, x, e, cosine, rows)
        if "second-best index" in out:
            out["second-best index"].append(v.topk(2, dim=1).indices[:, 1])
        if "last index on ties" in out:
            out["last index on ties"].append(K - 1 - v.flip(1).argmax(dim=1))
        if "one code tile left out" in out:
            cut = v.clone()
            cut[:, tile:2 * tile] = ninf
            out["one code tile left out"].append(cut.argmax(dim=1))
        if "the ragged last tile dropped" in out:
            cut = v.clone()
            cut[:, K // tile * tile:] = ninf
            out["the ragged last tile dropped"].append(cut.argmax(dim=1))
    return {w: torch.cat(parts) for w, parts in out.items()}


def hold_searches(torch, searches) -> None:
    """Each (name, search, x, e, faults): the search on the card equal to its
    twin index for index, and every planted fault (a dict of wrong
    indices, computed in torch) told apart by that exact gate: it differs
    from the twin in some row."""
    from fourm_torch.kernels import vq_codebook as vc

    for name, fn, x, e, faults in searches:
        got = fn(x, e)
        want = getattr(vc, fn.__name__ + "_plain")(x, e)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        check(bad == 0, f"{name}: {bad} of {x.shape[0]} indices differ from the twin")
        print(f"variant {name}: N={x.shape[0]}, K={e.shape[0]}, D={x.shape[1]}: equal to the "
              f"twin index for index", flush=True)
        for label, wrong in (faults or {}).items():
            rows = int((wrong != want).sum())
            print(f"  fault {label}: {rows} rows differ from the twin "
                  f"({'caught' if rows else 'NOT caught'})", flush=True)
            check(rows > 0, f"{name}: the exact gate cannot tell '{label}'")


def vq_kernel_cases(torch, rn, key_bias, gen):
    """The VQ tokenization kernels at the VQ paths' shapes (64 images of 196
    tokens at ViT-B width; the CLIP teacher's 197 tokens; 64 x 196 latents
    of 32 against 16384 and 8192 codes), and their options off the path."""
    import torch.nn.functional as F

    from fourm_torch.kernels import attention as at
    from fourm_torch.kernels import fused_mlp as fm
    from fourm_torch.kernels import vq_codebook as vc
    from fourm_torch.kernels.fused_mlp import _mm, layer_norm_fp32
    from fourm_torch.vq import l2norm

    dev, bf = "cuda", torch.bfloat16
    B, N, C, H, Dh, HID, NT = 64, 196, 768, 12, 64, 3072, 197

    def vec(n, std=0.1):
        return torch.randn(n, generator=gen, device=dev) * std

    # Wqkv and Wproj at 3x the lecun scale: peaked attention and a branch
    # larger than the residual, so that a head or a key tile left out moves
    # the output well past two bf16 ulps of its largest value
    x = rn(B, N, C)
    g1, b1 = torch.rand(C, generator=gen, device=dev) + 0.5, vec(C)
    wq, wp = rn(3 * C, C, std=3 * C ** -0.5), rn(C, C, std=3 * C ** -0.5)
    bq, bp = vec(3 * C), vec(C)

    def block(fn, xx=x, bias=None, biases=True, **kw):
        return lambda: fn(xx, g1, b1 if biases else None, wq, bq if biases else None, wp,
                          bp if biases else None, H, bias, **kw)

    def block_faults():
        """attn_block's output recomputed in fp32 from the twin's rounded
        q/k/v and head outputs, and with one head's output or the last key
        tile (keys 192..195, the kernel's last 64-key step) left out."""
        h = layer_norm_fp32(x.float(), g1, b1, 1e-6).to(bf)
        q, k, v = _mm(h, wq, bq).to(bf).split(C, dim=-1)
        attn = at.flash_mha_plain(q, k, v, H)
        no_head = attn.clone()
        no_head[..., 5 * Dh:6 * Dh] = 0
        short = at.flash_mha_plain(q, k[:, :192], v[:, :192], H)

        def out(a):
            return x.float() + _mm(a, wp, bp)

        wrong = {"one head's output left out": out(no_head), "last key tile left out": out(short)}
        return out(attn), wrong, set(wrong)

    def block_library():
        hh = F.layer_norm(x, (C,), g1.to(bf), b1.to(bf), 1e-6)
        q, k, v = F.linear(hh, wq, bq.to(bf)).reshape(B, N, 3, H, Dh).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, N, C)
        return x + F.linear(o, wp, bp.to(bf))

    xg = rn(B * N, C)
    wg1, wg2 = rn(HID, C, std=C ** -0.5), rn(C, HID, std=HID ** -0.5)
    bg1, bg2 = vec(HID), vec(C)

    def gelu_library():
        hh = F.layer_norm(xg, (C,), g1.to(bf), b1.to(bf), 1e-6)
        return xg + F.linear(F.gelu(F.linear(hh, wg1, bg1.to(bf))), wg2, bg2.to(bf))

    def mha_case(with_bias):
        return mha_short_row(torch, rn, key_bias, B, NT, C, H, with_bias, "vq_b")

    def search_case(name, K, path, N_rows=B * N, D=32, ties=False):
        """A search row. Its bound: the products exact on the CUDA cores
        (fp32 peak); beside it the design's own (`design`): the larger of the
        TF32 products (495 TFLOP/s) and the pass over the N*K screen scores
        (1 lane-instruction a score for cosine, the max; 2 for Euclidean,
        the FMA of 2 x.e - e2 and the max; 33.5 T lane-instructions/s), or,
        `ties` (every code equal, so every code is rescored), the exact
        rescoring of all N*K on the CUDA cores."""
        cosine = name.endswith("cosine")
        xl = torch.randn(N_rows, D, generator=gen, device=dev)
        e = torch.randn(K, D, generator=gen, device=dev)
        if ties:
            e = e[:1].repeat(K, 1)
        if cosine:
            xl, e = l2norm(xl), l2norm(e)
        fn, plain = getattr(vc, name), getattr(vc, name + "_plain")
        tf32_ms = 2 * N_rows * K * D / PEAK_TF32_FLOPS * 1e3
        design = ((max(tf32_ms, 2 * N_rows * K * D / PEAK_FP32_FLOPS * 1e3), "exact rescoring")
                  if ties else
                  max((tf32_ms, "TF32 products"),
                      (N_rows * K * (1 if cosine else 2) / (PEAK_FP32_FLOPS / 2) * 1e3,
                       "score pass")))
        return dict(
            run=lambda: fn(xl, e), plain=lambda: plain(xl, e), exact=True, path=path,
            library=(lambda: (xl @ e.t()).argmax(1)) if cosine
            else (lambda: torch.cdist(xl, e).argmin(1)),
            flops=2 * N_rows * K * D, peak=PEAK_FP32_FLOPS, design=design,
            bytes=(N_rows + K) * D * 4 + N_rows * 8,
            shape=f"x ({N_rows}, {D}) fp32 against ({K}, {D}) codes"
                  + (", every code equal" if ties else "") + ", exact fp32")

    ab = "fourm_torch/kernels/csrc/attn_block.cu"
    vq = "fourm_torch/kernels/csrc/vq_codebook.cu"
    cases = [
        ("attn_block", "fourm_tpu/kernels/attention.py:435", ab, dict(
            run=block(at.attn_block), plain=block(at.attn_block_plain), faults=block_faults,
            library=block_library, path="vq_a",
            flops=2 * B * N * C * 4 * C + 4 * B * H * N * N * Dh,
            bytes=(2 * B * N * C + 4 * C * C) * 2 + 6 * C * 4,
            shape=f"x (B={B}, N={N}, 768), 12 heads, LN bias + qkv/proj biases, no mask")),
        ("ln_mlp@gelu", "fourm_tpu/kernels/fused_mlp.py:244", "fourm_torch/kernels/csrc/ln_mlp.cu",
         dict(run=lambda: fm.ln_mlp(xg, g1, b1, wg1, bg1, wg2, bg2),
              plain=lambda: fm.ln_mlp_plain(xg, g1, b1, wg1, bg1, wg2, bg2),
              library=gelu_library, path="vq_a",
              flops=2 * 2 * B * N * C * HID,
              bytes=(2 * B * N * C + 2 * C * HID) * 2 + (3 * C + HID) * 4,
              shape=f"exact GELU, x ({B}*{N}, 768), hidden 3072, LN bias + biases")),
        ("mha_short", "fourm_tpu/kernels/attention.py:261", "fourm_torch/kernels/csrc/attention.cu",
         mha_case(False)),
        ("mha_short@key_bias", "fourm_tpu/kernels/attention.py:261",
         "fourm_torch/kernels/csrc/attention.cu", mha_case(True)),
        ("nearest_code_cosine", "fourm_tpu/kernels/vq_codebook.py:158", vq,
         search_case("nearest_code_cosine", 16384, "vq_a")),
        ("nearest_code_cosine@K8192", "fourm_tpu/kernels/vq_codebook.py:158", vq,
         search_case("nearest_code_cosine", 8192, "vq_b")),
        ("nearest_code", "fourm_tpu/kernels/vq_codebook.py:103", vq,
         search_case("nearest_code", 16384, "vq_a_euclid")),
        ("nearest_code_cosine@all_ties", "fourm_tpu/kernels/vq_codebook.py:158", vq,
         search_case("nearest_code_cosine", 16384, "vq_a", ties=True)),
    ]

    # options the VQ paths do not take, correctness only: a key bias (with a
    # fully masked image), softmax1, no biases, the largest N the kernel
    # holds and a tiny one; the Euclidean search at the CLIP codebook's size
    # (path B searches by cosine), on ragged N and K and on duplicate codes
    # (the first index wins), exactly
    kb = key_bias(B, N, full_rows=1)
    x448, x7, x129 = rn(3, 448, C), rn(5, 7, C), rn(3, 129, C)
    kb129 = key_bias(3, 129, full_rows=1)
    tie_e = torch.eye(32, device=dev).repeat(4, 1)
    tie_x = torch.eye(32, device=dev)
    rag = search_case("nearest_code", 1000, "", N_rows=1000)
    rag_c = search_case("nearest_code_cosine", 1000, "", N_rows=1000)
    k8 = search_case("nearest_code", 8192, "")
    searches = search_variants(torch, gen, B * N, dev)
    variants = [
        ("attn_block, key bias with 1 image fully masked",
         block(at.attn_block, bias=kb), block(at.attn_block_plain, bias=kb)),
        ("attn_block, softmax1, key bias, no biases",
         block(at.attn_block, bias=kb, biases=False, allow_zero_attn=True),
         block(at.attn_block_plain, bias=kb, biases=False, allow_zero_attn=True)),
        ("attn_block, N=448 (the most its shared memory holds)",
         block(at.attn_block, xx=x448), block(at.attn_block_plain, xx=x448)),
        ("attn_block, N=129, key bias", block(at.attn_block, xx=x129, bias=kb129),
         block(at.attn_block_plain, xx=x129, bias=kb129)),
        ("attn_block, N=7", block(at.attn_block, xx=x7), block(at.attn_block_plain, xx=x7)),
        ("nearest_code, N=12544, K=8192", k8["run"], k8["plain"], True),
        ("nearest_code, N=1000, K=1000", rag["run"], rag["plain"], True),
        ("nearest_code_cosine, N=1000, K=1000", rag_c["run"], rag_c["plain"], True),
        ("nearest_code, duplicate codes", lambda: vc.nearest_code(tie_x, tie_e),
         lambda: torch.arange(32, device=dev), True),
        ("nearest_code_cosine, duplicate codes", lambda: vc.nearest_code_cosine(tie_x, tie_e),
         lambda: torch.arange(32, device=dev), True),
    ]
    return cases, variants, searches


def search_variants(torch, gen, N: int, dev) -> list:
    """The searches off the main path, for hold_searches: in both forms, the
    adversarial codebooks at N rows, D = 16, 128 and 7 (padded to 8 by the
    wrapper), N = 1 and K = 1; the planted faults each where it shows: the
    second-best code and one code tile left out on random data, the last
    index on ties on the duplicated codes, the ragged last tile dropped at K
    = 1000, a zero margin on the TF32-collision codebook."""
    import torch.nn.functional as F

    from fourm_torch.kernels import vq_codebook as vc

    adversarial = adversarial_codebooks(torch, gen, N, 32, dev)

    def rand(n, k, d):
        return (F.normalize(torch.randn(n, d, generator=gen, device=dev), dim=-1),
                F.normalize(torch.randn(k, d, generator=gen, device=dev), dim=-1))

    out = []
    for fn in (vc.nearest_code_cosine, vc.nearest_code):
        cosine = fn is vc.nearest_code_cosine
        form = fn.__name__
        x, e = rand(N, 16384, 32)
        out.append((f"{form}, random, N={N}, K=16384", fn, x, e,
                    search_faults(torch, x, e, cosine,
                                  ("second-best index", "one code tile left out"))))
        for name, (x, e) in adversarial.items():
            faults = None
            if name == "duplicates":
                faults = search_faults(torch, x, e, cosine, ("last index on ties",))
            if name == "tf32_collisions":
                faults = {"zero margin": zero_margin_search(torch, x, e, cosine)}
            out.append((f"{form}, {name}", fn, x, e, faults))
        x, e = rand(N, 1000, 32)
        out.append((f"{form}, ragged last tile", fn, x, e,
                    search_faults(torch, x, e, cosine, ("the ragged last tile dropped",))))
        for D in (16, 128, 7):
            x, e = rand(N, 16384, D)
            out.append((f"{form}, D={D}", fn, x, e, None))
        x, e = rand(1, 16384, 32)
        out.append((f"{form}, N=1", fn, x, e, None))
        x, e = rand(N, 1, 32)
        out.append((f"{form}, K=1", fn, x, e, None))
    return out


def vq_kernel_phase(torch, card: str):
    """Phase 5: the VQ tokenization kernels against their twins, as phase 2;
    then the longest sequence attn_block takes at each width it takes, as
    its library reports it (the routing asks the same library)."""
    from fourm_torch.kernels import attention as at

    gen, rn, key_bias = random_makers(torch, 1)
    cases, variants, searches = vq_kernel_cases(torch, rn, key_bias, gen)
    results = time_cases(torch, cases, card)
    hold_variants(torch, variants)
    hold_searches(torch, searches)
    del searches
    longest = {C: max(N for N in range(1, 1025) if at.attn_block_takes(N, C, "cuda"))
               for C in (512, 768, 1024)}
    print(f"attn_block holds N <= {longest} (by width C)", flush=True)
    check(longest == ATTN_BLOCK_LONGEST, f"attn_block holds N <= {longest}, not "
                                         f"{ATTN_BLOCK_LONGEST} (its shared-memory design)")
    return results


def build_model(torch, dtype: str, device: str, seed: int = 0, name: str = MODEL,
                mods=(MOD21, MOD21_DEC), **overrides):
    from fourm_torch.models import FourM, create_fourm_config, init_weights

    cfg = create_fourm_config(name, *mods, dtype=dtype, **overrides)
    with torch.device(device):
        model = FourM(cfg)
    model = model.to(device=device, dtype=cfg.compute_dtype)
    return init_weights(model, seed).eval()


def chain_launches(depth: int, n_tok: int, kv_quant=None) -> dict:
    """Launches of each wrapper in one chain of a depth + depth model: per
    ROAR step 2 * depth ln_matmul, flash_mha and ln_mlp (encoder and
    decoder self-attention) and depth attention (decoder cross-attention);
    per AR prefill depth each of the encoder's three; per decoded token
    depth of each decode-step wrapper, the int8 kernel in int8 mode."""
    counts = {}
    for group, n in ((dict(ln_matmul=2 * depth, ln_mlp=2 * depth, flash_mha=2 * depth,
                           attention=depth), len(ROAR_TARGETS)),
                     (dict(ln_matmul=depth, ln_mlp=depth, flash_mha=depth), len(AR_TARGETS)),
                     ({"self_decode": depth, "cross_decode_attn": depth, "residual_mlp": depth,
                       ("decode_attention_int8" if kv_quant == "int8" else "decode_attention"):
                       depth}, n_tok)):
        for k, v in group.items():
            counts[k] = counts.get(k, 0) + v * n
    return counts


class PassLengths:
    """Records the token count of every encoder and decoder pass, and the
    rows of each encoder pass (a forward pre-hook on the first block of each
    stack; KV-cached decode steps run DecoderBlock.step and are not passes)."""

    def __init__(self, model):
        self.encoder, self.decoder, self.rows = [], [], []

        def encoder_pass(_m, args):
            self.encoder.append(args[0].shape[1])
            self.rows.append(args[0].shape[0])

        self._hooks = [model.encoder[0].register_forward_pre_hook(encoder_pass),
                       model.decoder[0].register_forward_pre_hook(
                           lambda _m, args: self.decoder.append(args[0].shape[1]))]

    def close(self):
        for h in self._hooks:
            h.remove()


# the longest sequence attn_block holds at each width it is built for (heads
# of 64): 3 x roundup(N, 64) x 128 bytes of q/k/v beside one 40 KB ring
# stage in 227 KB of shared memory (csrc/attn_block.cu:ab_stages); phase 5
# holds the kernel library's answer to this table
ATTN_BLOCK_LONGEST = {512: 448, 768: 448, 1024: 448}


def prenorm_launches(N: int, cfg) -> dict:
    """The wrappers one pre-norm self-attention half launches over N tokens
    under a key-only mask (ops/transformer.py:Attention.fused_prenorm),
    from fixed facts: one attn_block for a short unnormed sequence at a
    width and length ATTN_BLOCK_LONGEST holds (D = 384 is no attn_block
    width), else ln_matmul + mha_short for N <= 1024 without QK-norm, else
    ln_matmul + flash_mha."""
    if not cfg.qk_norm and N <= 1024:
        if N <= ATTN_BLOCK_LONGEST.get(cfg.dim, 0):
            return {"attn_block": 1}
        return {"ln_matmul": 1, "mha_short": 1}
    return {"ln_matmul": 1, "flash_mha": 1}


def pass_launches(model, lengths: PassLengths, n_tok: int, kv_quant=None) -> dict:
    """Launches of each wrapper in the recorded passes of a depth + depth
    model plus n_tok KV-cached decode steps: per encoder pass and block its
    self-attention half and ln_mlp; per decoder pass and block its
    self-attention half, attention and ln_mlp; per token and layer each
    decode-step wrapper."""
    cfg = model.config
    counts = {}

    def add(group, n):
        for k, v in group.items():
            counts[k] = counts.get(k, 0) + v * n

    for N in lengths.encoder:
        add(dict(prenorm_launches(N, cfg), ln_mlp=1), cfg.encoder_depth)
    for N in lengths.decoder:
        add(dict(prenorm_launches(N, cfg), attention=1, ln_mlp=1), cfg.decoder_depth)
    add({"self_decode": 1, "cross_decode_attn": 1, "residual_mlp": 1,
         ("decode_attention_int8" if kv_quant == "int8" else "decode_attention"): 1},
        cfg.decoder_depth * n_tok)
    return counts


def chain_phase(torch, model, card: str, requests: int = REQUESTS, depth: int = DEPTH,
                kv_quant=None, label: str = "chain", generic: bool = False,
                plain: bool = False):
    """Phase 3 (and 3b): `requests` requests, RGB -> all 14 targets, at full
    width. A warm-up run; then the public entry alone, with the launch
    counters reset just before and read just after it, gives samples/s; a
    third run, instrumented, gives each sequence target's seconds. The
    launch counts are chain_launches' (4M-B, XL), or, `generic`, those of
    the passes the run made (pass_launches: the narrow models, whose
    attention halves take mha_short or flash_mha by sequence length), or,
    `plain` (a float32 model, which the block layer sends to the plain
    twins), no launch at all."""
    from fourm_torch import kernels
    from fourm_torch.api import FourMSampler
    from fourm_torch.data.modality_info import MODALITY_INFO

    sampler = FourMSampler(model, StandInTokenizer(), kv_quant=kv_quant)  # the card, by default
    rgb = np.random.RandomState(0).rand(requests, 224, 224, 3).astype(np.float32)
    schedule = sampler.build_schedule(["rgb@224"], TARGETS)
    check([s["target_domain"] for s in schedule] == TARGETS, "schedule order")
    check(all(s["scheme"] == "roar" and s["cfg_scale"] == 2.0 and s["temperature"] == 0.01
              for s in schedule[:len(ROAR_TARGETS)]),
          "image targets are not DEFAULTS_RGB2X's one-step ROAR with CFG 2.0")
    check(all(s["scheme"] == "autoregressive" and s["cfg_scale"] == 1.0
              for s in schedule[len(ROAR_TARGETS):]), "sequence targets are not AR")

    def run():
        md = sampler.prepare_sample({"rgb@224": rgb}, ["rgb@224"], TARGETS,
                                    batch_size=requests)
        out = sampler.generate(md, schedule, seed=0)
        torch.cuda.synchronize()
        return out

    run()  # warm-up: cuBLAS handles, allocator
    lengths = PassLengths(model)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()  # the public entry alone: samples/s and the launch counts
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    lengths.close()
    tokens = dict(sampler.sampler._ar_tokens)

    # a third run, instrumented: each sequence target's seconds (its
    # prefill, token loop and merge, fenced by syncs) and its encoder budget
    # (the cross K/V length its tokens read)
    ar_seconds, ar_budget = {}, {}
    inner = sampler.sampler._generate_seq_target

    def timed(mod_dict, step_info, *args, **kwargs):
        ar_budget[step_info["target_domain"]] = sampler.sampler._encoder_budget(
            kwargs["counts"], mod_dict)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(mod_dict, step_info, *args, **kwargs)
        torch.cuda.synchronize()
        ar_seconds[step_info["target_domain"]] = time.perf_counter() - t0
        return out

    sampler.sampler._generate_seq_target = timed
    t0 = time.perf_counter()
    run()
    seconds_inst = time.perf_counter() - t0
    del sampler.sampler._generate_seq_target  # the class's method again

    for t in TARGETS:
        spec = MODALITY_INFO[t]
        d = out[t]
        tok = d["tensor"]
        check(bool(d["target_mask"].all()), f"{t}: still has targets")
        if spec.type == "img":
            check(not bool(d["input_mask"].any()), f"{t}: not fully decoded")
            check(tok.shape == (requests, spec.resolved_max_tokens()), f"{t}: shape")
        else:  # decoded to the target's bound, or to EOS in every row
            bound = spec.resolved_max_tokens() - 1
            check(0 < tokens[t] <= bound, f"{t}: {tokens[t]} tokens decoded, bound {bound}")
            check(tok.shape == (requests, (spec.resolved_max_tokens() + 1) * 2), f"{t}: shape")
        check(int(tok.min()) >= 0 and int(tok.max()) < spec.vocab_size,
              f"{t}: token outside [0, vocab)")
    n_tok = sum(tokens.values())
    expected = {k: 0 for k in launches}
    if not plain:
        expected.update(pass_launches(model, lengths, n_tok, kv_quant) if generic
                        else chain_launches(depth, n_tok, kv_quant))
    check(launches == expected, f"{label}: launch counts {launches} != {expected}")
    ar_s = sum(ar_seconds.values())
    img_s = seconds_inst - ar_s
    print(f"{label}: {requests} requests x {len(TARGETS)} targets, FourMSampler.generate alone: "
          f"{seconds:.4f} s, {requests / seconds:.4f} samples/s; {card}", flush=True)
    print(f"{label}, instrumented run (the third): {seconds_inst:.4f} s; image targets (batch "
          f"{2 * requests} with CFG) {img_s:.4f} s, {img_s / len(ROAR_TARGETS):.4f} s/target; "
          f"sequence targets {ar_s:.4f} s for {n_tok} decoded tokens, "
          f"{ar_s / n_tok * 1e3:.4f} ms/token with prefill and merge", flush=True)
    for t in AR_TARGETS:
        print(f"  {t}: {tokens[t]} tokens, {ar_seconds[t]:.4f} s, "
              f"{ar_seconds[t] / tokens[t] * 1e3:.4f} ms/token, encoder budget {ar_budget[t]}",
              flush=True)
    print(f"{label} launches {json.dumps(launches)}", flush=True)
    return out, launches, seconds


def token_agreement(torch, out_a, out_b, label: str, card: str) -> None:
    """Share of equal tokens per sequence target between two chain runs.
    Printed, not gated: with random weights it decides nothing."""
    shares = {t: (out_a[t]["tensor"] == out_b[t]["tensor"]).float().mean().item()
              for t in AR_TARGETS}
    print(f"{label}: token agreement per sequence target {json.dumps(shares)}; {card}",
          flush=True)


def decode_bench(torch, model, out, card: str, kv_quant=None, label: str = "") -> float:
    """The decode microbenchmark of bench.py:301-363 at B = 16, L = 256,
    M = 2304: ar_prefill of caption (and, in int8 mode, the cross K/V
    quantized as the sampler does), then 64 greedy tokens
    (embed_target_token, decode_one_token, mod_logits, argmax); best of 3
    runs, each from fresh caches. Returns ms per token."""
    from fourm_torch.kernels.decode_step import quantize_kv_decode

    B, L, M, steps, target = 16, 256, 2304, 64, "caption"
    md = {m: {k: torch.cat([v] * -(-B // v.shape[0]))[:B] for k, v in d.items()}
          for m, d in out.items()}
    with torch.inference_mode():
        cross_kvs, enc_mask, y_emb = model.ar_prefill(md, target, L, M)
        if kv_quant == "int8":
            cross_kvs = [((k, ks), (v, vs))
                         for k, ks, v, vs in (quantize_kv_decode(*kv) for kv in cross_kvs)]
        check(enc_mask.shape == (B, M), f"decode bench: encoder stream {tuple(enc_mask.shape)}")
        best = None
        for rep in range(4):  # the first run warms up
            caches = model.init_kv_caches(B, L)
            tok = torch.full((B, 1), 7, dtype=torch.int32, device=model.device)
            step = torch.zeros(1, dtype=torch.int32, device=model.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                y = model.embed_target_token(target, tok) + y_emb[:, i:i + 1]
                y, caches = model.decode_one_token(y, caches, cross_kvs, enc_mask, step)
                tok = model.mod_logits(target, y)[:, 0].argmax(-1).to(torch.int32)[:, None]
                step += 1
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
            if rep:
                best = ms if best is None else min(best, ms)
    depth = len(model.decoder)
    print(f"decode bench{label}: ar_decode_ms_per_token{'_int8kv' if kv_quant else ''} "
          f"{best:.4f} (B={B}, L={L}, M={M}, {steps} greedy caption tokens, {depth} layers, "
          f"width {model.config.dim}, best of 3); {card}", flush=True)
    return best


def cpu_models(torch, model, name: str = MODEL, **overrides):
    """The card model's weights on the CPU, in fp32 and in bf16 (overrides:
    build_model's)."""
    state = {k: v.float().cpu() for k, v in model.state_dict().items()}
    models = {}
    for dtype in ("float32", "bfloat16"):
        models[dtype] = build_model(torch, dtype, "cpu", name=name, **overrides)
        models[dtype].load_state_dict(state)
    return models


def gate(torch, name: str, gpu, ref, ref_bf16, what: str) -> float:
    """Card bf16 logits against fp32 CPU logits: bf16 carries 8 significant
    bits through 24 blocks, so the card's path may be as far from fp32 as
    the plain bf16 path is, not much further. Returns the error."""
    err = (gpu - ref).abs().max().item()
    err_plain = (ref_bf16 - ref).abs().max().item()
    tol = 2.0 * err_plain + 1e-3
    agree = (gpu.argmax(-1) == ref.argmax(-1)).float().mean().item()
    agree_plain = (ref_bf16.argmax(-1) == ref.argmax(-1)).float().mean().item()
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol  # a bf16 error cannot flip these
    # with no such position (flat random-weight logits) the argmax gate has
    # nothing to hold; the logit gate still does
    n_decided = int(decided.sum())
    agree_decided = (gpu.argmax(-1) == ref.argmax(-1))[decided].float().mean().item() \
        if n_decided else 1.0
    print(f"{name}: {what}: logits max abs err {err:.6g} vs fp32 (tol {tol:.6g}; plain bf16 "
          f"{err_plain:.6g}; logit std {ref.std().item():.6g}); argmax agreement {agree:.6f} "
          f"(plain bf16 {agree_plain:.6f}), {agree_decided:.6f} on the {n_decided} of "
          f"{decided.numel()} positions whose fp32 top-2 margin exceeds 2*tol", flush=True)
    check(bool(torch.isfinite(gpu).all()), f"{name}: non-finite logits")
    check(err <= tol, f"{name}: logits error {err} > {tol}")
    check(agree_decided >= 0.99, f"{name}: argmax agreement {agree_decided} < 0.99")
    return err


def _on(md, dev):
    return {m: {k: v.to(dev) for k, v in d.items()} for m, d in md.items()}


def parity_phase(torch, model, out, cpu, label: str = "parity"):
    """Phase 4a: one forward_generation_img at batch 2 over the image
    targets, card bf16 kernels against the CPU plain twins in fp32 (and in
    bf16, to size bf16's own error)."""
    from fourm_torch.generate import GenerationSampler

    target = "tok_clip@224"
    md = {m: {k: v[:2] for k, v in out[m].items()} for m in ("rgb@224", *ROAR_TARGETS)}
    md[target] = dict(md[target], input_mask=torch.ones_like(md[target]["input_mask"]),
                      target_mask=torch.zeros_like(md[target]["target_mask"]))
    sampler = GenerationSampler(model)
    budget = sampler._encoder_budget(sampler._init_valid_counts(md), md)
    sa = torch.ones(2, 196, dtype=torch.bool, device=model.device)
    logits = {}
    with torch.inference_mode():
        gpu = model.forward_generation_img(md, target, sa, budget).float().cpu()
        for dtype, m in cpu.items():
            logits[dtype] = m.forward_generation_img(_on(md, "cpu"), target, sa.cpu(),
                                                     budget).float()
    gate(torch, label, gpu, logits["float32"], logits["bfloat16"],
         f"forward_generation_img B=2 {target}, encoder budget {budget}")


def decode_parity_phase(torch, model, out, cpu, kv_quant=None, label: str = "decode parity"):
    """Phase 4b: ar_prefill of det (conditioned on RGB, the CLIP tokens and
    the caption the chain decoded) + 4 teacher-forced decode_one_token steps
    at batch 2, card bf16 kernels against the CPU plain twins; in int8 mode
    each run quantizes its own cross K/V after the prefill, as the sampler
    does, and the CPU runs take the int8 twins."""
    from fourm_torch.generate import GenerationSampler
    from fourm_torch.kernels.decode_step import quantize_kv_decode

    target, L, steps = "det", 16, 4
    md = {m: {k: v[:2] for k, v in out[m].items()} for m in ("rgb@224", "tok_clip@224", "caption")}
    sampler = GenerationSampler(model)
    budget = sampler._encoder_budget(sampler._init_valid_counts(md), md)
    toks = torch.from_numpy(np.random.RandomState(5).randint(30, 30000, (2, steps)))

    def run(m, dev):
        with torch.inference_mode():
            kvs, mask, emb = m.ar_prefill(_on(md, dev), target, L, budget)
            if kv_quant == "int8":
                kvs = [((k, ks), (v, vs)) for k, ks, v, vs in (quantize_kv_decode(*kv)
                                                               for kv in kvs)]
            caches = m.init_kv_caches(2, L)
            step = torch.zeros(1, dtype=torch.int32, device=dev)
            logits = []
            for t in range(steps):
                y = m.embed_target_token(target, toks[:, t:t + 1].to(dev)) + emb[:, t:t + 1]
                y, caches = m.decode_one_token(y, caches, kvs, mask, step)
                logits.append(m.mod_logits(target, y)[:, 0].float().cpu())
                step += 1
        return torch.stack(logits, 1)

    gpu = run(model, model.device)
    ref = {dtype: run(m, "cpu") for dtype, m in cpu.items()}
    gate(torch, label, gpu, ref["float32"], ref["bfloat16"],
         f"ar_prefill {target} + {steps} decode steps B=2, encoder budget {budget}"
         + (", int8 cross K/V" if kv_quant else ""))


def build_tokenizers(torch, device: str = "cuda") -> dict:
    """Phase 10's tokenizers, {transform key: TokenizerBundle}: the ViT-B
    VQ-VAEs of CLIP-B16, DINOv2-B14, ImageBind-H14 and COCO semseg and the
    UNet-P4 DiVAEs of depth, normals, canny and SAM edges, at full width in
    bf16, with seeded random weights (init_vq_weights with spread 0.1: the
    biases, norm scales, mask tokens and layer scales drawn too, so no layer
    the JAX modules initialise to zero passes on nothing)."""
    from fourm_torch.utils.decoding import TokenizerBundle
    from fourm_torch.vq import VQVAE, DiVAE, init_vq_weights

    specs = [(k, VQVAE, kw) for k, kw in VQVAE_TOKENIZERS.items()]
    specs += [(k, DiVAE, DIVAE_UNETP4) for k in DIVAE_TOKENIZERS]
    return {k: TokenizerBundle(init_vq_weights(cls(**kw, device=device), 100 + i, spread=0.1))
            for i, (k, cls, kw) in enumerate(specs)}


def decode_phase(torch, model, out, bundles: dict, card: str):
    """Phase 10a: FourMSampler.decode over phase 3's output (8 requests, RGB
    and the 14 targets) with the 4M-21 tokenizers at full width, 25
    diffusion steps (12 for the edges), to_rgb on. After a warm-up call, the
    launch counters are reset just before and read just after the first of
    three timed calls (the median is the figure); a fourth, instrumented
    call times each tokenizer's decode. Returns (the decoded dict, the
    launch counts)."""
    from fourm_torch import kernels
    from fourm_torch.api import FourMSampler
    from fourm_torch.data.modality_info import MODALITY_INFO

    sampler = FourMSampler(model, StandInTokenizer(), tokenizers=bundles)

    def run():
        dec = sampler.decode(out, decoding_steps=DECODE_STEPS, seed=0)
        torch.cuda.synchronize()
        return dec

    run()  # warm-up: cuDNN plans, allocator
    walls = []
    for i in range(3):
        if i == 0:
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        dec = run()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = kernels.launch_counts()
    wall = float(np.median(walls))
    expected = {k: 0 for k in launches}
    expected.update(PER_DECODE)
    check(launches == expected, f"decode: launch counts {launches} != {expected}")

    seconds = {}  # the instrumented call: each tokenizer's decode, fenced
    for k, b in bundles.items():
        def timed(*a, _inner=b.decode_tokens, _k=k, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = _inner(*a, **kw)
            torch.cuda.synchronize()
            seconds[_k] = time.perf_counter() - t0
            return res
        b.decode_tokens = timed
    run()
    for b in bundles.values():
        del b.decode_tokens  # the class's method again

    check(set(dec) == {"rgb@224", *TARGETS}, f"decode: keys {sorted(dec)}")
    B = REQUESTS
    for t in ["rgb@224"] + ROAR_TARGETS + ["color_palette"]:
        img = dec[t]
        n = {"tok_clip@224": 14, "tok_dinov2@224": 16, "tok_imagebind@224": 16}.get(t, 224)
        check(isinstance(img, np.ndarray) and img.shape == (B, n, n, 3), f"decode: {t} shape "
              f"{getattr(img, 'shape', type(img))}")
        # palette values are v0=<0..999> / 255, as the JAX package draws them
        top = np.inf if t == "color_palette" else 1.0
        check(bool(np.isfinite(img).all()) and img.min() >= 0 and img.max() <= top,
              f"decode: {t} values outside [0, {top}]")
    for t in ("caption", "det", "human_poses", "sam_instance"):
        check(isinstance(dec[t], list) and len(dec[t]) == B and all(isinstance(x, str)
                                                                   for x in dec[t]),
              f"decode: {t} is not {B} strings")
    check(isinstance(dec["metadata"], list) and len(dec["metadata"]) == B
          and all(isinstance(x, dict) for x in dec["metadata"]), "decode: metadata")
    check("matplotlib" not in sys.modules, "decode: to_rgb imported matplotlib")
    n_img = len(ROAR_TARGETS)
    print(f"decode: FourMSampler.decode of {B} requests (rgb@224 + {len(TARGETS)} targets, "
          f"{DECODE_STEPS} diffusion steps, {max(DECODE_STEPS // 2, 1)} for the edges, to_rgb, "
          f"without matplotlib): {wall * 1e3:.3f} ms per call (median of "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)}), {B / wall:.4f} requests/s, "
          f"{B * n_img / wall:.4f} decoded target images/s, {wall / n_img * 1e3:.3f} ms per "
          f"image target ({B} images); {card}", flush=True)
    for k, sec in seconds.items():
        steps = ("" if k not in DIVAE_TOKENIZERS else
                 f", {max(DECODE_STEPS // 2, 1) if 'edge' in k else DECODE_STEPS} steps")
        print(f"  {k}: {sec * 1e3:.3f} ms ({B} images{steps})", flush=True)
    print(f"decode launches {json.dumps(launches)}", flush=True)
    for t in AR_TARGETS:
        spec = MODALITY_INFO[t]
        print(f"  {t} ({spec.type}): {str(dec[t][0])[:100]!r}", flush=True)
    return dec, launches


def uvit_decode_phase(torch, card: str):
    """Phase 10a, its second part: 8 token grids from [0, 1024) decoded by
    the UViT-B DiVAE of divae/rgb/ViTB-UViTB_1k_224_predv_frozenenc.yaml at 25 steps, seeded
    random bf16 weights; exact launch counts (a mid block's attention core
    per layer and step, 300) over one call after a warm-up, the median of
    three calls. Returns (the launch counts, the model)."""
    from fourm_torch import kernels
    from fourm_torch.vq import DiVAE, divae_decode_tokens, init_vq_weights

    divae = init_vq_weights(DiVAE(**DIVAE_UVITB, device="cuda"), 110, spread=0.1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 1024, (REQUESTS, 14, 14), generator=gen, device="cuda")

    def run():
        img = divae_decode_tokens(divae, tokens, gen, timesteps=DECODE_STEPS)
        torch.cuda.synchronize()
        return img

    with torch.inference_mode():
        run()
        walls = []
        for i in range(3):
            if i == 0:
                kernels.reset_launch_counts()
            t0 = time.perf_counter()
            img = run()
            walls.append(time.perf_counter() - t0)
            if i == 0:
                launches = kernels.launch_counts()
    wall = float(np.median(walls))
    expected = {k: 0 for k in launches}
    expected.update(PER_UVIT_DECODE)
    check(launches == expected, f"uvit decode: launch counts {launches} != {expected}")
    check(tuple(img.shape) == (REQUESTS, 224, 224, 3) and img.dtype == torch.float32
          and bool(torch.isfinite(img).all()), "uvit decode: output")
    print(f"uvit decode: UViT-B DiVAE, {REQUESTS} grids of 14 x 14 tokens, {DECODE_STEPS} steps: "
          f"{wall * 1e3:.3f} ms per call (median of {', '.join(f'{w * 1e3:.3f}' for w in walls)}),"
          f" {wall / DECODE_STEPS * 1e3:.3f} ms per step, {REQUESTS / wall:.4f} images/s; {card}",
          flush=True)
    print(f"uvit decode launches {json.dumps(launches)}", flush=True)
    return launches, divae


def decode_tokens_parity_phase(torch, bundles: dict, uvit, out, dec: dict) -> None:
    """Phase 10c: on the card in bf16 against the same weights on the CPU in
    fp32 and in bf16 (phase 4's gate): each ViT-B decoder's output at batch
    2, one denoise_step of the UNet-P4 at batch 1 and of the UViT-B at batch
    2, and one divae_decode_tokens of 3 steps of the UNet-P4 at batch 1,
    every run fed the same noise; then decode_dict's text, metadata, box and
    palette outputs of the card's decode equal to the CPU's."""
    from fourm_torch.utils.decoding import decode_dict
    from fourm_torch.vq import VQVAE, DiVAE, divae_decode_tokens
    from fourm_torch.vq.scheduling import spaced_timesteps

    def gate(name, gpu, cpu_run):
        t0 = time.perf_counter()
        ref = {dt: cpu_run(m).float() for dt, m in cpu.items()}
        latent_gate(torch, f"{name} ({time.perf_counter() - t0:.1f} s on the CPU)",
                    gpu.float().cpu(), ref["float32"], ref["bfloat16"], label="decode parity")

    gen = torch.Generator(device="cuda").manual_seed(5)
    with torch.inference_mode():
        for k, kw in VQVAE_TOKENIZERS.items():
            m = bundles[k].model
            n = 224 // (14 if k in ("tok_dinov2", "tok_imagebind") else 16)
            toks = out[f"{k}@224"]["tensor"][:2].reshape(2, n, n)
            cpu = cpu_copies(m, lambda dt: VQVAE(**dict(kw, dtype=dt), device="cpu"))
            gate(f"{k} ViT-B decoder B=2", m.decode_tokens(toks),
                 lambda c: c.decode_tokens(toks.cpu()))
        m = bundles["tok_depth"].model
        toks = out["tok_depth@224"]["tensor"][:1].reshape(1, 14, 14)
        noised = torch.randn(1, 224, 224, 3, generator=gen, device="cuda")
        cpu = cpu_copies(m, lambda dt: DiVAE(**dict(DIVAE_UNETP4, dtype=dt), device="cpu"))
        gate("UNet-P4 denoise_step t=500 B=1", m.denoise_step(noised, 500,
                                                             m.tokens_to_embedding(toks)),
             lambda c: c.denoise_step(noised.cpu(), 500, c.tokens_to_embedding(toks.cpu())))
        n_draws = 1 + len(spaced_timesteps(1000, 3, "trailing"))
        draws = [torch.randn(1, 224, 224, 3, generator=gen, device="cuda") for _ in range(n_draws)]
        gate("UNet-P4 divae_decode_tokens 3 steps B=1, the same noise",
             divae_decode_tokens(m, toks, timesteps=3, noise=draws[0], step_noise=draws[1:]),
             lambda c: divae_decode_tokens(c, toks.cpu(), timesteps=3, noise=draws[0].cpu(),
                                           step_noise=[d.cpu() for d in draws[1:]]))
        toks = torch.randint(0, 1024, (2, 14, 14), generator=gen, device="cuda")
        noised = torch.randn(2, 224, 224, 3, generator=gen, device="cuda")
        cpu = cpu_copies(uvit, lambda dt: DiVAE(**dict(DIVAE_UVITB, dtype=dt), device="cpu"))
        gate("UViT-B denoise_step t=500 B=2", uvit.denoise_step(noised, 500,
                                                               uvit.tokens_to_embedding(toks)),
             lambda c: c.denoise_step(noised.cpu(), 500, c.tokens_to_embedding(toks.cpu())))
    host = decode_dict({t: {k: v.cpu() for k, v in out[t].items()} for t in AR_TARGETS}, {},
                       StandInTokenizer())
    for t in AR_TARGETS:
        same = (np.array_equal(host[t], dec[t]) if t == "color_palette" else host[t] == dec[t])
        check(same, f"decode parity: {t} differs from the CPU's decode_dict")
    print(f"decode parity: {', '.join(AR_TARGETS)} of the card's decode equal the CPU's "
          f"decode_dict ({sum(len(str(host[t])) for t in AR_TARGETS)} characters)", flush=True)


def count_syncs(torch, fn):
    """fn() under torch.cuda's sync debug mode: its result and the number of
    synchronizing operations it made (torch's warnings, one each)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return res, sum("synchroniz" in str(w.message) for w in caught)


def sr_budgets(cond_tokens: int, n_targets: int) -> list:
    """The encoder pass length of each SR target's steps, from fixed facts:
    the valid tokens at the target's last step (the conditions' and every
    784-token grid's so far) rounded up to 256, or the whole stream (the
    conditions and every grid) when that is no shorter
    (generate/sampler.py:_group_budget)."""
    total = cond_tokens + n_targets * SR_GRID
    out = []
    for i in range(n_targets):
        bucket = -(-(cond_tokens + SR_GRID * (i + 1)) // 256) * 256
        out.append(total if bucket >= total else bucket)
    return out


def sr_launches(cfg, budgets) -> dict:
    """Launches of each wrapper in one SR chain: per MaskGIT step (8 a
    target), per encoder block its self-attention half over the target's
    budget (prenorm_launches: past 1024 tokens ln_matmul + flash_mha without
    QK-norm) and ln_mlp; per decoder block its self-attention half over the
    784 grid tokens under a key-only mask (ln_matmul + mha_short: past
    attn_block's 448), the cross-attention core and ln_mlp."""
    counts = {}
    for N in budgets:
        for group, depth in ((dict(prenorm_launches(N, cfg), ln_mlp=1), cfg.encoder_depth),
                             (dict(prenorm_launches(SR_GRID, cfg), attention=1, ln_mlp=1),
                              cfg.decoder_depth)):
            for k, v in group.items():
                counts[k] = counts.get(k, 0) + v * depth * SR_STEPS
    return counts


def check_sr_targets(out, targets, requests: int, label: str) -> None:
    from fourm_torch.data.modality_info import MODALITY_INFO

    for t in targets:
        d, spec = out[t], MODALITY_INFO[t]
        check(tuple(d["tensor"].shape) == (requests, SR_GRID), f"{label}: {t} shape")
        check(bool(d["target_mask"].all()) and not bool(d["input_mask"].any()),
              f"{label}: {t} not fully decoded")
        check(int(d["tensor"].min()) >= 0 and int(d["tensor"].max()) < spec.vocab_size,
              f"{label}: {t} token outside [0, vocab)")


def sr_phase(torch, card: str):
    """Phase 3c: the SR-448 chain of bench.py:508-533 at full width: 4M-L
    (SR_MODEL on SR_MODS, uncut, random bf16 weights), 4 requests
    conditioned on random rgb@224 pixels and tok_rgb@224 ids, the 5
    DEFAULT_ORDER_SR targets through FourMSampler.generate (8 MaskGIT steps
    each, CFG 2.0). A warm-up run, counting the host syncs; then three timed
    runs (samples/s from their median), the launch counters reset just
    before and read just after the first, checked exactly against
    sr_launches (and each pass's length against sr_budgets); a fifth run,
    instrumented, times each target. Returns (the model, the last timed
    run's output, the launch counts)."""
    from fourm_torch import kernels
    from fourm_torch.api import FourMSampler

    model = build_model(torch, "bfloat16", "cuda", name=SR_MODEL, mods=SR_MODS)
    print(f"sr model {SR_MODEL}: {sum(p.numel() for p in model.parameters())} parameters, "
          f"bf16, random (seed 0); {len(SR_MODS[0])} encoder modalities", flush=True)
    sampler = FourMSampler(model, StandInTokenizer())  # the card, by default
    rng = np.random.RandomState(0)
    sample = {"rgb@224": rng.rand(SR_REQUESTS, 224, 224, 3).astype(np.float32),
              "tok_rgb@224": rng.randint(0, 16384, (SR_REQUESTS, 196)).astype(np.int32)}
    schedule = sampler.build_schedule(SR_CONDS, SR_TARGETS)
    check([s["target_domain"] for s in schedule] == [t for t in SR_TARGETS
                                                     for _ in range(SR_STEPS)], "sr: schedule")
    check(all(s["scheme"] == "maskgit" and s["cfg_scale"] == 2.0 and s["temperature"] == 1.0
              for s in schedule), "sr: not DEFAULTS_SR's MaskGIT with CFG 2.0")
    check(all(sum(s["num_tokens"] for s in schedule if s["target_domain"] == t) == SR_GRID
              for t in SR_TARGETS), "sr: a target's steps do not fill its grid")

    def run(seed):
        md = sampler.prepare_sample(sample, SR_CONDS, SR_TARGETS, batch_size=SR_REQUESTS)
        return sampler.generate(md, schedule, seed=seed)

    _, syncs = count_syncs(torch, lambda: run(0))  # the warm-up
    torch.cuda.synchronize()
    walls = []
    for i in range(3):
        if i == 0:
            lengths = PassLengths(model)
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = run(1 + i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = kernels.launch_counts()
            lengths.close()
    wall = float(np.median(walls))
    budgets = sr_budgets(2 * 196, len(SR_TARGETS))
    check(lengths.encoder == [b for b in budgets for _ in range(SR_STEPS)],
          f"sr: encoder passes {lengths.encoder} != budgets {budgets}")
    check(lengths.decoder == [SR_GRID] * (SR_STEPS * len(SR_TARGETS)) and
          set(lengths.rows) == {2 * SR_REQUESTS}, "sr: decoder passes or rows")
    expected = {k: 0 for k in launches}
    expected.update(sr_launches(model.config, budgets))
    check(launches == expected, f"sr: launch counts {launches} != {expected}")
    for w in ("ln_matmul", "ln_mlp", "flash_mha", "attention", "mha_short"):
        check(launches.get(w, 0) > 0, f"sr: no {w} launch on the SR path")
    check_sr_targets(out, SR_TARGETS, SR_REQUESTS, "sr")

    seconds = {}  # the instrumented run: each target's steps, fenced
    inner = sampler.sampler._generate_img_target

    def timed(mod_dict, group, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(mod_dict, group, *a, **kw)
        torch.cuda.synchronize()
        seconds[group[0]["target_domain"]] = time.perf_counter() - t0
        return res

    sampler.sampler._generate_img_target = timed
    run(4)
    del sampler.sampler._generate_img_target  # the class's method again
    print(f"sr chain: {SR_MODEL}, {SR_REQUESTS} requests ({', '.join(SR_CONDS)}) x "
          f"{len(SR_TARGETS)} targets of {SR_GRID} tokens ({SR_STEPS} MaskGIT steps, CFG 2.0, "
          f"{2 * SR_REQUESTS} rows), FourMSampler.generate: {wall:.4f} s per run (median of "
          f"{', '.join(f'{w:.4f}' for w in walls)}), {SR_REQUESTS / wall:.4f} samples/s; "
          f"{syncs} host syncs a run (sync debug mode, the warm-up); encoder budgets "
          f"{budgets}; {card}", flush=True)
    for t in SR_TARGETS:
        print(f"  {t}: {seconds[t]:.4f} s ({seconds[t] / SR_STEPS * 1e3:.3f} ms a step)",
              flush=True)
    print(f"sr launches {json.dumps(launches)}", flush=True)
    return model, out, launches


def super_resolve_phase(torch, card: str, sr_model, base, chain_out):
    """Phase 3c, its second part: FourMSampler(base, fm_sr=sr_model)
    .super_resolve of phase 3's 4M-B chain output (8 requests): its 9 @224
    entries condition, 4 targets (the chain has no tok_rgb@224, so no
    tok_rgb@448), kv_quant off; the launch counts of the call, checked
    exactly against sr_launches. Returns the launch counts."""
    from fourm_torch import kernels
    from fourm_torch.api import FourMSampler
    from fourm_torch.data.modality_info import MODALITY_INFO

    sampler = FourMSampler(base, StandInTokenizer(), fm_sr=sr_model)
    conds = [m for m in chain_out if m.endswith("@224")]
    targets = [t for t in SR_TARGETS if t.replace("@448", "@224") in chain_out]
    check(targets == SR_TARGETS[:4], f"super_resolve: targets {targets}")
    cond_tokens = sum(196 if m.startswith("rgb") else MODALITY_INFO[m].resolved_max_tokens()
                      for m in conds)
    lengths = PassLengths(sr_model)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler.super_resolve(chain_out, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    lengths.close()
    check(list(out) == conds + targets, f"super_resolve: keys {list(out)}")
    budgets = sr_budgets(cond_tokens, len(targets))
    check(lengths.encoder == [b for b in budgets for _ in range(SR_STEPS)],
          f"super_resolve: encoder passes {lengths.encoder} != budgets {budgets}")
    expected = {k: 0 for k in launches}
    expected.update(sr_launches(sr_model.config, budgets))
    check(launches == expected, f"super_resolve: launch counts {launches} != {expected}")
    check_sr_targets(out, targets, REQUESTS, "super_resolve")
    print(f"super_resolve: phase 3's 4M-B chain output, {REQUESTS} requests, {len(conds)} @224 "
          f"conditions ({cond_tokens} tokens) -> {len(targets)} @448 targets by {SR_MODEL}: "
          f"{wall:.4f} s (one call), {REQUESTS / wall:.4f} samples/s; encoder budgets "
          f"{budgets}; {card}", flush=True)
    print(f"super_resolve launches {json.dumps(launches)}", flush=True)
    return launches


def sr_parity_phase(torch, out) -> None:
    """Phase 4c: one SR MaskGIT step at batch 2 with 4M-L cut to 2 + 2
    layers at full width: tok_depth@448 with every position still masked,
    conditioned on phase 3c's rgb@224, tok_rgb@224 and tok_clip@448 (the
    later targets empty), at the encoder budget the chain gives it (2048:
    N x M = 784 x 2048 past 1024^2, where the JAX package hands over to
    flash_attention); card bf16 kernels (exact launch counts) against the
    CPU plain twins in fp32 and in bf16 (phase 4's gate)."""
    from fourm_torch import kernels
    from fourm_torch.generate import GenerationSampler

    cut = dict(name=SR_MODEL, mods=SR_MODS, encoder_depth=2, decoder_depth=2)
    model = build_model(torch, "bfloat16", "cuda", seed=1, **cut)
    cpu = cpu_models(torch, model, **cut)
    target = "tok_depth@448"
    md = {m: {k: v[:2] for k, v in out[m].items()} for m in SR_CONDS + SR_TARGETS}
    for t in SR_TARGETS[1:]:  # tok_depth@448 and the later targets still to decode
        md[t] = dict(md[t], input_mask=torch.ones_like(md[t]["input_mask"]),
                     target_mask=torch.zeros_like(md[t]["target_mask"]))
    sampler = GenerationSampler(model)
    budget = sampler._group_budget(sampler._init_valid_counts(md), md,
                                   [{"target_domain": target, "num_tokens": SR_GRID}])
    check(budget == sr_budgets(2 * 196, len(SR_TARGETS))[1], f"sr parity: budget {budget}")
    sa = torch.ones(2, SR_GRID, dtype=torch.bool, device=model.device)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        gpu = model.forward_generation_img(md, target, sa, budget).float().cpu()
        launches = kernels.launch_counts()
        logits = {dt: m.forward_generation_img(_on(md, "cpu"), target, sa.cpu(), budget).float()
                  for dt, m in cpu.items()}
    expected = {k: 0 for k in launches}
    expected.update({k: v // SR_STEPS for k, v in sr_launches(model.config, [budget]).items()})
    check(launches == expected, f"sr parity: launch counts {launches} != {expected}")
    gate(torch, "sr parity (2 + 2 layers)", gpu, logits["float32"], logits["bfloat16"],
         f"forward_generation_img B=2 {target}, MaskGIT's first step, encoder budget {budget}, "
         f"launches {json.dumps(launches)}")


def decode448_phase(torch, model, out, bundles: dict, uvit, card: str):
    """Phase 10b: FourMSampler.decode of phase 3c's tok_clip@448,
    tok_depth@448, tok_normal@448 and tok_semseg@448 (4 requests) at 448
    (decode_dict reads the resolution from the @448 keys) through phase 10's
    224-trained tokenizers: the ViT-B VQ-VAEs of CLIP-B16 and COCO semseg on
    28 x 28 grids (positions resized bicubically; 784 tokens, so ln_matmul +
    mha_short, not attn_block), the UNet-P4 DiVAEs of depth and normals at
    448 x 448, 25 steps; then phase 10's UViT-B DiVAE decoding 4 grids of 28
    x 28 of its codes at 448, 25 steps. Each: a warm-up call, the launch
    counters reset just before and read just after the first of three timed
    calls (the median is the figure), checked exactly, the peak device
    memory of that call; for the decode a fifth, instrumented call times
    each tokenizer and its own peak. Then parity (phase 10c's gates): the
    CLIP ViT-B decoder at batch 2, one UNet-P4 step at batch 1 and one UViT-B
    step at batch 1, at 448. Returns the two calls' launch counts."""
    from fourm_torch import kernels
    from fourm_torch.api import FourMSampler
    from fourm_torch.vq import VQVAE, DiVAE, divae_decode_tokens

    toks = {k: bundles[k] for k in ("tok_clip", "tok_semseg", "tok_depth", "tok_normal")}
    sampler = FourMSampler(model, StandInTokenizer(), tokenizers=toks)
    gen = torch.Generator(device="cuda").manual_seed(6)
    grids = torch.randint(0, 1024, (SR_REQUESTS, 28, 28), generator=gen, device="cuda")

    def decode():
        res = sampler.decode(out, decoding_steps=DECODE_STEPS, seed=0, keys=DECODE448_TARGETS)
        torch.cuda.synchronize()
        return res

    def uvit_decode():
        with torch.inference_mode():
            img = divae_decode_tokens(uvit, grids, gen, timesteps=DECODE_STEPS, image_size=448)
        torch.cuda.synchronize()
        return img

    def timed_calls(run):
        """A warm-up call, then three timed: (the last result, walls, launch
        counts and peak / held MiB of the first)."""
        run()
        walls = []
        for i in range(3):
            if i == 0:
                kernels.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated() / 2**20
            t0 = time.perf_counter()
            res = run()
            walls.append(time.perf_counter() - t0)
            if i == 0:
                launches = kernels.launch_counts()
                peak = torch.cuda.max_memory_allocated() / 2**20
        return res, walls, launches, peak, held

    dec, walls, launches, peak, held = timed_calls(decode)
    expected = {k: 0 for k in launches}
    expected.update(PER_DECODE448)
    check(launches == expected, f"decode448: launch counts {launches} != {expected}")
    seconds, peaks = {}, {}  # the instrumented call: each tokenizer, fenced
    for k, b in toks.items():
        def timed(*a, _inner=b.decode_tokens, _k=k, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            res = _inner(*a, **kw)
            torch.cuda.synchronize()
            seconds[_k] = time.perf_counter() - t0
            peaks[_k] = (torch.cuda.max_memory_allocated() - start) / 2**20
            return res
        b.decode_tokens = timed
    decode()
    for b in toks.values():
        del b.decode_tokens  # the class's method again
    check(list(dec) == DECODE448_TARGETS, f"decode448: keys {list(dec)}")
    for t in DECODE448_TARGETS:
        n = 28 if t == "tok_clip@448" else 448  # CLIP: a PCA image of the feature grid
        img = dec[t]
        check(isinstance(img, np.ndarray) and img.shape == (SR_REQUESTS, n, n, 3),
              f"decode448: {t} shape {getattr(img, 'shape', type(img))}")
        check(bool(np.isfinite(img).all()) and img.min() >= 0 and img.max() <= 1,
              f"decode448: {t} values outside [0, 1]")
    wall = float(np.median(walls))
    n_img = len(DECODE448_TARGETS)
    print(f"decode448: FourMSampler.decode of the SR chain's {', '.join(DECODE448_TARGETS)} for "
          f"{SR_REQUESTS} requests at 448 ({DECODE_STEPS} diffusion steps): {wall * 1e3:.3f} ms "
          f"per call (median of {', '.join(f'{w * 1e3:.3f}' for w in walls)}), "
          f"{SR_REQUESTS / wall:.4f} requests/s, {SR_REQUESTS * n_img / wall:.4f} decoded target "
          f"images/s; peak device memory {peak:.1f} MiB ({peak - held:.1f} above the "
          f"{held:.1f} MiB held before the call); {card}", flush=True)
    for k, sec in seconds.items():
        print(f"  {k}: {sec * 1e3:.3f} ms ({SR_REQUESTS} images at 448"
              f"{'' if k in ('tok_clip', 'tok_semseg') else f', {DECODE_STEPS} steps'}), peak "
              f"{peaks[k]:.1f} MiB above its start", flush=True)
    print(f"decode448 launches {json.dumps(launches)}", flush=True)

    img, walls, uvit_launches, peak, held = timed_calls(uvit_decode)
    expected = {k: 0 for k in uvit_launches}
    expected.update(PER_UVIT_DECODE)
    check(uvit_launches == expected,
          f"uvit decode448: launch counts {uvit_launches} != {expected}")
    check(tuple(img.shape) == (SR_REQUESTS, 448, 448, 3) and bool(torch.isfinite(img).all()),
          "uvit decode448: output")
    wall = float(np.median(walls))
    print(f"uvit decode448: UViT-B DiVAE, {SR_REQUESTS} grids of 28 x 28 tokens at 448, "
          f"{DECODE_STEPS} steps: {wall * 1e3:.3f} ms per call (median of "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)}), {wall / DECODE_STEPS * 1e3:.3f} ms per "
          f"step; peak device memory {peak:.1f} MiB ({peak - held:.1f} above the call's start); "
          f"{card}", flush=True)
    print(f"uvit decode448 launches {json.dumps(uvit_launches)}", flush=True)

    def gate448(name, gpu, cpu, cpu_run):
        t0 = time.perf_counter()
        ref = {dt: cpu_run(m).float() for dt, m in cpu.items()}
        latent_gate(torch, f"{name} ({time.perf_counter() - t0:.1f} s on the CPU)",
                    gpu.float().cpu(), ref["float32"], ref["bfloat16"], label="decode448 parity")

    with torch.inference_mode():
        m = toks["tok_clip"].model
        grid = out["tok_clip@448"]["tensor"][:2].reshape(2, 28, 28)
        gate448("tok_clip ViT-B decoder B=2 at 784 tokens", m.decode_tokens(grid),
                cpu_copies(m, lambda dt: VQVAE(**dict(VQVAE_TOKENIZERS["tok_clip"], dtype=dt),
                                               device="cpu")),
                lambda c: c.decode_tokens(grid.cpu()))
        m = toks["tok_depth"].model
        grid = out["tok_depth@448"]["tensor"][:1].reshape(1, 28, 28)
        noised = torch.randn(1, 448, 448, 3, generator=gen, device="cuda")
        gate448("UNet-P4 denoise_step t=500 B=1 at 448",
                m.denoise_step(noised, 500, m.tokens_to_embedding(grid)),
                cpu_copies(m, lambda dt: DiVAE(**dict(DIVAE_UNETP4, dtype=dt), device="cpu")),
                lambda c: c.denoise_step(noised.cpu(), 500, c.tokens_to_embedding(grid.cpu())))
        grid = grids[:1]
        noised = torch.randn(1, 448, 448, 3, generator=gen, device="cuda")
        gate448("UViT-B denoise_step t=500 B=1 at 448",
                uvit.denoise_step(noised, 500, uvit.tokens_to_embedding(grid)),
                cpu_copies(uvit, lambda dt: DiVAE(**dict(DIVAE_UVITB, dtype=dt), device="cpu")),
                lambda c: c.denoise_step(noised.cpu(), 500, c.tokens_to_embedding(grid.cpu())))
    return launches, uvit_launches


def generate_api_phase(torch, model, card: str) -> dict:
    """Phase 3f: the rest of the generation API at 4M-21 B full width
    (phase 3's model): generate_iter against generate on one seed at
    temperature 0 (tok_clip@224 by 4 MaskGIT steps and tok_depth@224 by 2
    ROAR steps, both with CFG 2.0, then caption autoregressively; 4
    requests), the last yield bit for bit; generate_multi_guided with 2
    conditions (two images, the unconditional dict's image empty) at batch
    2, one ROAR step over tok_clip@224's 196 tokens, one forward of 6 rows,
    exact launch counts; generate_sam_dense over 4 replicas of one request,
    sam_instance cut to a 32-token region, exact launch counts (the decode
    step's wrappers, rows 6-9, once per layer and token). Returns
    {path: launch counts}."""
    from fourm_torch import kernels
    from fourm_torch.api import FourMSampler
    from fourm_torch.data.modality_info import MODALITY_INFO
    from fourm_torch.generate import build_chained_generation_schedules, init_empty_target_modality

    sampler = FourMSampler(model, StandInTokenizer())
    gs, depth = sampler.sampler, len(model.decoder)
    rgb = np.random.RandomState(3).rand(4, 224, 224, 3).astype(np.float32)
    targets = ["tok_clip@224", "tok_depth@224", "caption"]
    schedule = build_chained_generation_schedules(
        ["rgb@224"], targets, [196, 196, 256], ["maskgit", "roar", "autoregressive"],
        [4, 2, None], ["cosine", "linear", None], [0.0] * 3, ["constant"] * 3, [2.0, 2.0, 1.0],
        ["constant"] * 3, cfg_grow_conditioning=True, modality_info=MODALITY_INFO)
    md = sampler.prepare_sample({"rgb@224": rgb}, ["rgb@224"], targets, batch_size=4)
    t0 = time.perf_counter()
    steps = list(gs.generate_iter(md, schedule, seed=7))
    torch.cuda.synchronize()
    iter_s = time.perf_counter() - t0
    ref = gs.generate(md, schedule, seed=7)
    check(len(steps) == len(schedule), "generate_iter: one yield per step")
    decoded = [int(s["tok_clip@224"]["target_mask"].sum()) for s in steps[:4]]
    check(decoded == list(np.cumsum([4 * s["num_tokens"] for s in schedule[:4]])),
          f"generate_iter: MaskGIT's decoded counts {decoded}")
    same = all(torch.equal(steps[-1][m][k], ref[m][k]) for m in ref for k in ref[m])
    check(same, "generate_iter: the last yield differs from generate's output")
    print(f"generate_iter: {len(steps)} yields (4 MaskGIT, 2 ROAR, 1 AR target of "
          f"{gs._ar_tokens['caption']} tokens), {iter_s:.4f} s; the last yield equals "
          f"generate's output bit for bit (temperature 0, seed 7); {card}", flush=True)

    def rgb_dict(images, empty=False):
        d = sampler.prepare_sample({"rgb@224": images}, ["rgb@224"], ["tok_clip@224"],
                                   batch_size=len(images))
        if empty:
            d["rgb@224"]["input_mask"][:] = True
        return d

    multi = [{"target_domain": "tok_clip@224", "scheme": "roar", "num_tokens": 196,
              "temperature": 0.0, "cfg_scale": [1.5, 0.5], "cfg_cond_domains": []}]
    lengths = PassLengths(model)
    kernels.reset_launch_counts()
    res = gs.generate_multi_guided(rgb_dict(rgb[:2], empty=True), [rgb_dict(rgb[:2]),
                                                                   rgb_dict(rgb[2:])], multi)
    torch.cuda.synchronize()
    multi_launches = kernels.launch_counts()
    lengths.close()
    d = res["tok_clip@224"]
    check(bool(d["target_mask"].all()) and not bool(d["input_mask"].any()),
          "generate_multi_guided: not fully decoded")
    check(lengths.rows == [6] and lengths.encoder == [392] and lengths.decoder == [196],
          f"generate_multi_guided: passes {lengths.rows} rows, {lengths.encoder} + "
          f"{lengths.decoder} tokens")
    expected = {k: 0 for k in multi_launches}
    expected.update(ln_matmul=2 * depth, flash_mha=2 * depth, ln_mlp=2 * depth, attention=depth)
    check(multi_launches == expected,
          f"generate_multi_guided: launch counts {multi_launches} != {expected}")
    print(f"generate_multi_guided: 2 conditions, B=2, one ROAR step over 196 tokens, one forward "
          f"of {lengths.rows[0]} rows; launches {json.dumps(multi_launches)}", flush=True)

    one = sampler.prepare_sample({"rgb@224": rgb[:1]}, ["rgb@224"], [], batch_size=1)
    init_empty_target_modality(one, "sam_instance", 1, 32)
    sam = sampler.build_schedule(["rgb@224"], ["sam_instance"])
    kernels.reset_launch_counts()
    res = gs.generate_sam_dense(one, sam, batch_size=4, seed=0)
    torch.cuda.synchronize()
    sam_launches = kernels.launch_counts()
    n_tok = gs._ar_tokens["sam_instance"]
    check(0 < n_tok <= 31, f"generate_sam_dense: {n_tok} tokens decoded")
    merged = res["sam_instance"]["tensor"]
    check(merged.shape[0] == 1 and merged.device.type == "cuda", "generate_sam_dense: merged")
    expected = {k: 0 for k in sam_launches}
    expected.update(ln_matmul=depth, flash_mha=depth, ln_mlp=depth)
    expected.update({w: depth * n_tok for w in ("self_decode", "cross_decode_attn",
                                                "residual_mlp", "decode_attention")})
    check(sam_launches == expected,
          f"generate_sam_dense: launch counts {sam_launches} != {expected}")
    print(f"generate_sam_dense: 4 replicas x {n_tok} tokens, merged into one row of "
          f"{merged.shape[1]}; launches {json.dumps(sam_launches)}", flush=True)
    return {"multi_guided": multi_launches, "sam_dense": sam_launches}


def xl_phase(torch, card: str):
    """Phases 3b and 4b: the 14-target chain at 4M-21 XL, full width
    and depth, for 4 requests in bf16 and in int8 mode, with the token
    agreement of the two; the decode microbenchmark at XL in both modes;
    then, at depth cut to 2 + 2, forward and decode parity (bf16 and int8)
    against fp32 CPU runs. Returns the two chains' launch counts."""
    model = build_model(torch, "bfloat16", "cuda", name=XL_MODEL)
    params = sum(p.numel() for p in model.parameters())
    blocks = sum(p.numel() for n, p in model.named_parameters()
                 if n.startswith(("encoder.", "decoder.")))
    print(f"xl model {XL_MODEL}: {params} parameters, {blocks} in the 24 + 24 blocks, "
          f"bf16, random (seed 0)", flush=True)
    out, xl_launches, _ = chain_phase(torch, model, card, XL_REQUESTS, XL_DEPTH,
                                      label="xl_chain")
    out8, int8_launches, _ = chain_phase(torch, model, card, XL_REQUESTS, XL_DEPTH,
                                         kv_quant="int8", label="int8_chain")
    token_agreement(torch, out, out8, "xl_chain bf16 vs int8", card)
    decode_bench(torch, model, out, card, label=" XL")
    decode_bench(torch, model, out, card, kv_quant="int8", label=" XL")
    del model, out8
    torch.cuda.empty_cache()
    cut = dict(encoder_depth=2, decoder_depth=2)  # depth cut for the CPU's fp32 runs
    model = build_model(torch, "bfloat16", "cuda", seed=1, name=XL_MODEL, **cut)
    cpu = cpu_models(torch, model, XL_MODEL, **cut)
    parity_phase(torch, model, out, cpu, label="xl parity (2 + 2 layers)")
    decode_parity_phase(torch, model, out, cpu, label="xl decode parity (2 + 2 layers)")
    decode_parity_phase(torch, model, out, cpu, kv_quant="int8",
                        label="xl int8 decode parity (2 + 2 layers)")
    return xl_launches, int8_launches


NARROW = ("fm_tiny_6e_6d_gelu", "fm_tiny_6e_6d_swiglu_nobias", "fm_small_8e_8d_swiglu_nobias")
NARROW_PATHS = dict(zip(NARROW, ("tiny_chain", "tiny_swiglu", "small")))


def w2_update_check(torch) -> None:
    """4M-21 XL at depth 1 + 1, built in bf16 on the card under
    torch.inference_mode() (its weights inference tensors, with no version
    counter): residual_mlp with decoder block 0's weights against its twin,
    then again after fc2's weight (hidden 5461, kept in zero-padded storage)
    is updated in place; the kernel must read the new weight."""
    from fourm_torch.kernels import decode_step as ds

    with torch.inference_mode():
        model = build_model(torch, "bfloat16", "cuda", seed=2, name=XL_MODEL,
                            encoder_depth=1, decoder_depth=1)
        blk = model.decoder[0]
        mlp, bf = blk.mlp, torch.bfloat16
        gen = torch.Generator(device="cuda").manual_seed(9)
        C, HID = mlp.fc2.weight.shape
        x, attn = (torch.randn(4, C, generator=gen, device="cuda").to(bf) for _ in range(2))

        def both():
            args = (x, attn, blk.cross_attn.proj.weight, None, blk.norm2.weight, None,
                    mlp.fc1.weight, None, mlp.fc2.weight, None, mlp.fc3.weight, None)
            out = ds.residual_mlp(*args, gated=True).float()
            ref = ds.residual_mlp_plain(*args, gated=True).float()
            torch.cuda.synchronize()
            err, tol = (out - ref).abs().max().item(), 2.0 ** -6 * ref.abs().max().item()
            return out, err, tol

        before, err0, tol0 = both()
        mlp.fc2.weight.copy_(torch.randn(C, HID, generator=gen, device="cuda").to(bf)
                             * HID ** -0.5)
        after, err1, tol1 = both()
        moved = (after - before).abs().max().item()
    print(f"residual_mlp after an in-place fc2 update under inference mode (4M-21 XL, "
          f"hidden {HID}, W2 row stride {mlp.fc2.weight.stride(0)}): max abs error {err0:.6g} "
          f"(tol {tol0:.6g}) before, {err1:.6g} (tol {tol1:.6g}) after; the update moved the "
          f"output by {moved:.6g}", flush=True)
    check(err0 <= tol0 and err1 <= tol1 and moved > tol1,
          "residual_mlp does not read fc2's weight as it is now")
    del model
    torch.cuda.empty_cache()


def narrow_kernel_phase(torch, card: str):
    """Phase 2c: ln_matmul and ln_mlp at the widths of the narrow registry
    models (D = 384: GELU hidden 1536 with biases, SwiGLU hidden 1024; D =
    512: SwiGLU hidden 1365, ragged), at a chain's encoder rows (8 requests,
    16 with CFG, 1024 tokens), as phase 2, with the ragged-tail and
    W2-tail faults at hidden 1365."""
    gen, rn, _ = random_makers(torch, 6)
    rows = 16 * 1024
    lmm, slm = "fourm_tpu/kernels/fused_mlp.py:181", "fourm_torch/kernels/csrc/ln_matmul.cu"
    lml, sml = "fourm_tpu/kernels/fused_mlp.py:244", "fourm_torch/kernels/csrc/ln_mlp.cu"
    cases = [
        ("ln_matmul@tiny", lmm, slm, ln_matmul_row(torch, rn, gen, rows, 384, 1152, True,
                                                   path="tiny_chain")),
        ("ln_mlp@tiny_gelu", lml, sml, ln_mlp_row(torch, rn, gen, rows, 384, 1536, False, True,
                                                  path="tiny_chain")),
        ("ln_mlp@tiny_swiglu", lml, sml, ln_mlp_row(torch, rn, gen, rows, 384, 1024, True,
                                                    path="tiny_swiglu")),
        ("ln_matmul@small", lmm, slm, ln_matmul_row(torch, rn, gen, rows, 512, 1536,
                                                    path="small")),
        ("ln_mlp@small", lml, sml, ln_mlp_row(torch, rn, gen, rows, 512, 1365, True,
                                              path="small", w2_tail_gain=8.0)),
    ]
    return time_cases(torch, cases, card)


def sr_kernel_phase(torch, card: str):
    """Phase 2d: the kernels at the shapes of the SR-448 chain (4M-L: D =
    1024, 16 heads, SwiGLU hidden 2730, no QK-norm; 4 requests, 8 rows with
    CFG; its longest encoder stream SR_LONGEST tokens, the 784-token decoder
    grid) and of the decoding at 448 (the ViT-B decoders' 784 tokens, the
    UViT-B's N = M = 784 mid-block attention), as phase 2, with phase 2's
    faults (the last, ragged key tile left out, a stale V stage, one head's
    output left out; ln_mlp's ragged tail tile and W2's tail columns)."""
    import torch.nn.functional as F

    from fourm_torch.kernels import attention as at

    gen, rn, key_bias = random_makers(torch, 7)
    B, N, C, H = 2 * SR_REQUESTS, SR_LONGEST, 1024, 16
    fa = ATTENTION_CU
    lmm, slm = "fourm_tpu/kernels/fused_mlp.py:181", "fourm_torch/kernels/csrc/ln_matmul.cu"
    lml, sml = "fourm_tpu/kernels/fused_mlp.py:244", "fourm_torch/kernels/csrc/ln_mlp.cu"

    def uvit_case(B_, N_):
        q, k, v = rn(B_, 12, N_, 64, std=2.0), rn(B_, 12, N_, 64), rn(B_, 12, N_, 64)
        return dict(
            run=lambda: at.attention(q, k, v, None),
            plain=lambda: at.attention_plain(q, k, v, None),
            library=lambda: F.scaled_dot_product_attention(q, k, v),
            faults=lambda: attention_faults(q, k, v, None), path="uvit_decode448",
            flops=4 * B_ * 12 * N_ * N_ * 64, bytes=4 * B_ * 12 * N_ * 64 * 2,
            shape=f"q, k, v (B={B_}, 12, N=M={N_}, 64), no mask")

    cases = [
        ("flash_mha@SR", "fourm_tpu/kernels/attention.py:587", fa,
         dict(flash_row(torch, rn, key_bias, None, B, N, C, H), path="sr_chain")),
        ("attention@SR_cross", "fourm_tpu/kernels/attention.py:127", fa,
         dict(attention_row(torch, rn, gen, key_bias, B, SR_GRID, N, H=H), path="sr_chain")),
        ("ln_matmul@SR", lmm, slm, ln_matmul_row(torch, rn, gen, B * N, C, 3 * C,
                                                 path="sr_chain")),
        ("ln_mlp@SR", lml, sml, ln_mlp_row(torch, rn, gen, B * N, C, 2730, True,
                                           path="sr_chain", w2_tail_gain=8.0)),
        ("mha_short@SR_decoder", "fourm_tpu/kernels/attention.py:261", fa,
         mha_short_row(torch, rn, key_bias, B, SR_GRID, C, H, True, "sr_chain")),
        ("mha_short@ViTB_448", "fourm_tpu/kernels/attention.py:261", fa,
         mha_short_row(torch, rn, key_bias, SR_REQUESTS, SR_GRID, 768, 12, False, "decode448")),
        ("attention@UViTB_448", "fourm_tpu/kernels/attention.py:325", fa,
         uvit_case(SR_REQUESTS, SR_GRID)),
    ]
    return time_cases(torch, cases, card)


def narrow_phase(torch, card: str) -> dict:
    """Phase 3d: the narrow registry models in bf16 on the card, through the
    kernels. The fm_tiny_6e_6d_gelu chain (8 requests, 14 targets, full
    depth 6 + 6) with exact launch counts by the passes it made (encoder
    halves take mha_short up to 1024 tokens, flash_mha past it; D = 384 is
    no attn_block width); then each narrow model at full depth, one
    forward_generation_img and one ar_prefill + 4 decode steps at batch 2
    against its weights on the CPU in fp32 and bf16 (phase 4's gates), with
    exact launch counts. Returns each model's launches by path."""
    from fourm_torch import kernels

    counts = {}
    out = None
    for i, name in enumerate(NARROW):
        model = build_model(torch, "bfloat16", "cuda", seed=10 + i, name=name)
        if out is None:
            out, counts[NARROW_PATHS[name]], _ = chain_phase(
                torch, model, card, REQUESTS, model.config.encoder_depth,
                label=f"tiny_chain ({name})", generic=True)
        cpu = cpu_models(torch, model, name)
        lengths = PassLengths(model)
        kernels.reset_launch_counts()
        parity_phase(torch, model, out, cpu, label=f"{name} parity")
        decode_parity_phase(torch, model, out, cpu, label=f"{name} decode parity")
        launches = kernels.launch_counts()
        lengths.close()
        expected = {k: 0 for k in launches}
        expected.update(pass_launches(model, lengths, 4))
        check(launches == expected, f"{name}: launch counts {launches} != {expected}")
        print(f"{name}: parity passes launches {json.dumps({k: v for k, v in launches.items() if v})}"
              f"; {card}", flush=True)
        counts.setdefault(NARROW_PATHS[name], launches)
        del model, cpu
        torch.cuda.empty_cache()
    return counts


def fp32_phase(torch, card: str) -> None:
    """Phase 3e: a float32 model on the card, sent to the plain twins by the
    block layer (ops/transformer.py:_kernels; no kernel launched): 4M-21 B
    cut to 2 + 2 layers, the 14-target chain for
    2 requests through FourMSampler.generate, then one forward_generation_img
    at batch 2 against the same weights on the CPU in fp32; then bench.py's
    4M-B mod-7 train model cut to 2 + 2 layers in fp32, one train step at
    batch 2 (the plain autograd attention, fused_adamw's fp32 kernel
    launched once) against one on the CPU in fp32. TF32 is off for
    matmuls and cuDNN, so the card and the CPU differ only in summation
    order: logits within 1e-4 of the largest fp32 logit, the loss within
    1e-5 relative and the gradient within 1e-4 relative (in norm), some
    10x the fp32 rounding such orders give over 2 + 2 layers."""
    from fourm_torch import kernels
    from fourm_torch.generate import GenerationSampler
    from fourm_torch.parallel import build_train_step, init_train_state
    from fourm_torch.utils.optim import constant_schedule, create_optimizer

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "fp32 phase: TF32 must be off")
    cut = dict(encoder_depth=2, decoder_depth=2)
    model = build_model(torch, "float32", "cuda", seed=5, **cut)
    out, _, _ = chain_phase(torch, model, card, 2, 2, label="fp32_chain (2 + 2 layers)",
                            plain=True)
    cpu = build_model(torch, "float32", "cpu", **cut)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    target = "tok_clip@224"
    md = {m: {k: v[:2] for k, v in out[m].items()} for m in ("rgb@224", *ROAR_TARGETS)}
    md[target] = dict(md[target], input_mask=torch.ones_like(md[target]["input_mask"]),
                      target_mask=torch.zeros_like(md[target]["target_mask"]))
    gs = GenerationSampler(model)
    budget = gs._encoder_budget(gs._init_valid_counts(md), md)
    sa = torch.ones(2, 196, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        gpu = model.forward_generation_img(md, target, sa, budget).float().cpu()
        ref = cpu.forward_generation_img(_on(md, "cpu"), target, sa.cpu(), budget).float()
    err, scale = (gpu - ref).abs().max().item(), ref.abs().max().item()
    print(f"fp32 parity: forward_generation_img B=2 {target} (2 + 2 layers), card fp32 (plain "
          f"twins) vs CPU fp32: max abs err {err:.6g} (tol {1e-4 * scale:.6g}, max |logit| "
          f"{scale:.6g}); {card}", flush=True)
    check(bool(torch.isfinite(gpu).all()) and err <= 1e-4 * scale,
          f"fp32 parity: logits error {err} > {1e-4 * scale}")
    del model, cpu, out
    torch.cuda.empty_cache()

    start = {k: v.cpu() for k, v in train_model(torch, "cuda", "float32", 7, **cut)
             .state_dict().items()}
    tmodel = train_model(torch, "cuda", "float32", None, **cut)
    tmodel.load_state_dict(start)
    tx = create_optimizer(tmodel, constant_schedule(1e-3), weight_decay=0.05, betas=(0.9, 0.95))
    state = init_train_state(tmodel, tx)
    kernels.reset_launch_counts()
    state, metrics = build_train_step(tmodel, tx, TRAIN_TOKENS, TRAIN_TOKENS)(
        state, train_batch(torch, 2, 1, "cuda"))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expected = {k: 0 for k in launches}
    expected["fused_adamw"] = 1
    check(launches == expected, f"fp32 train step: launch counts {launches} != {expected}")
    grads = [torch.zeros_like(p).cpu() if p.grad is None else p.grad.float().cpu()
             for p in tx.params()]
    cm = train_model(torch, "cpu", "float32", None, **cut)
    cm.load_state_dict(start)
    loss, _ = cm(train_batch(torch, 2, 1, "cpu"), TRAIN_TOKENS, TRAIN_TOKENS)
    loss.backward()
    ref = [torch.zeros_like(p) if p.grad is None else p.grad for _, p in cm.named_parameters()]
    card_loss = float(metrics["loss"])
    loss_err = abs(card_loss - loss.item()) / abs(loss.item())
    num = sum(float((g - r).square().sum()) for g, r in zip(grads, ref))
    grad_err = (num / sum(float(r.square().sum()) for r in ref)) ** 0.5
    print(f"fp32 train step (mod-7 4M-B, 2 + 2 layers, B=2): launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; loss {card_loss:.6g} vs CPU "
          f"{loss.item():.6g} (relative {loss_err:.3g}, tol 1e-5); gradient relative error "
          f"{grad_err:.3g} (tol 1e-4); {card}", flush=True)
    check(np.isfinite(card_loss) and loss_err <= 1e-5, f"fp32 train: loss error {loss_err}")
    check(grad_err <= 1e-4, f"fp32 train: gradient error {grad_err}")
    del tmodel, tx, state, cm


def vq448_phase(torch, models, card: str) -> dict:
    """Phase 7b: the 224-trained RGB tokenizer on 448 x 448 inputs (a 28 x 28
    grid, its positions resized bicubically) at batch 2 on the card: exact
    launch counts (784 tokens pass attn_block's shared memory, so each block
    runs ln_matmul + mha_short, then ln_mlp; one search), and the latents
    and tokens against the CPU in fp32 and bf16 (phase 7's gates). Returns
    the launches."""
    from fourm_torch import kernels
    from fourm_torch.vq import VQ

    vq = models["rgb"]
    x = torch.from_numpy(np.random.RandomState(448).rand(2, 448, 448, 3)
                         .astype(np.float32)).cuda()
    kernels.reset_launch_counts()
    tokens = vq.tokenize(x)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expected = {k: 0 for k in launches}
    expected.update(ln_matmul=DEPTH, mha_short=DEPTH, ln_mlp=DEPTH, nearest_code_cosine=1)
    check(launches == expected, f"vq 448: launch counts {launches} != {expected}")
    check(tuple(tokens.shape) == (2, 28, 28), f"vq 448: tokens {tuple(tokens.shape)}")
    print(f"vq 448: RGB tokenizer (224-trained) on 2 images of 448 x 448: tokens "
          f"{tuple(tokens.shape)}, launches {json.dumps({k: v for k, v in launches.items() if v})}"
          f"; {card}", flush=True)
    state = {k: v.float().cpu() for k, v in vq.state_dict().items()}
    cpu = {}
    for dt in ("float32", "bfloat16"):
        cpu[dt] = VQ(**dict(VQ_RGB, dtype=dt), device="cpu")
        cpu[dt].load_state_dict(state)
    lat = vq.latents(x)
    ref = {dt: m.latents(x.cpu()).float() for dt, m in cpu.items()}
    tol = latent_gate(torch, "RGB tokenizer latents at 448, B=2", lat.float().cpu(),
                      ref["float32"], ref["bfloat16"])
    token_gate(torch, "RGB tokenizer at 448", vq, lat, cpu["float32"], ref["float32"], tol)
    return launches


def vq_phase(torch, card: str):
    """Phase 6: one tokenize call per path with exact launch counts, then
    images/s over 10 timed calls after a warm-up (bench.py:186-198)."""
    from fourm_torch import kernels
    from fourm_torch.vq import (
        TEACHER_PRESETS,
        VQ,
        ViTTeacher,
        init_teacher_weights,
        init_vq_weights,
    )

    models = {"rgb": init_vq_weights(VQ(**VQ_RGB), 0),  # the card, by default
              "rgb_euclid": init_vq_weights(VQ(**dict(VQ_RGB, norm_codes=False)), 1),
              "teacher": init_teacher_weights(
                  ViTTeacher(**TEACHER_PRESETS["CLIP-B16"], dtype="bfloat16"), 2),
              "clip": init_vq_weights(VQ(**VQ_CLIP), 3)}
    x = torch.from_numpy(np.random.RandomState(0).rand(VQ_BATCH, 224, 224, 3)
                         .astype(np.float32)).cuda()
    feats = {}

    def clip_path():
        feats["clip"] = models["teacher"](x)
        return models["clip"].tokenize(feats["clip"])

    paths = {"vq_a": (lambda: models["rgb"].tokenize(x), 16384,
                      "RGB tokenizer (VQ 224/16 vit_b_enc, 16384 codes, cosine)"),
             "vq_a_euclid": (lambda: models["rgb_euclid"].tokenize(x), 16384,
                             "RGB tokenizer, Euclidean codebook"),
             "vq_b": (clip_path, 8192, "CLIP-B16 teacher + CLIP tokenizer (1x1, post-MLP, 8192 "
                                       "codes, cosine)")}
    counts = {}
    for path, (run, K, what) in paths.items():
        run()  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        tokens = run()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        expected = {k: PER_VQ_PATH[path].get(k, 0) for k in launches}
        check(launches == expected, f"{path}: launch counts {launches} != {expected}")
        check(tuple(tokens.shape) == (VQ_BATCH, 14, 14), f"{path}: tokens {tuple(tokens.shape)}")
        check(int(tokens.min()) >= 0 and int(tokens.max()) < K, f"{path}: token outside [0, K)")
        t0 = time.perf_counter()
        for _ in range(10):
            out = run()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 10
        print(f"vq {path}: {what}: {VQ_BATCH} images, {dt * 1e3:.4f} ms per call, "
              f"{VQ_BATCH / dt:.4f} images/s; {len(torch.unique(out))} distinct tokens; "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}; {card}",
              flush=True)
        counts[path] = launches
    f = feats["clip"]
    check(tuple(f.shape) == (VQ_BATCH, 14, 14, 512) and bool(torch.isfinite(f).all()),
          f"CLIP-B16 features {tuple(f.shape)}")
    return counts, models, x


def latent_gate(torch, name: str, gpu, ref, ref_bf16, label: str = "vq parity") -> float:
    """Card bf16 values against the fp32 CPU run: within 2 x (the plain bf16
    path's error) + 1e-3, as phase 4. Returns that tolerance."""
    err = (gpu - ref).abs().max().item()
    err_plain = (ref_bf16 - ref).abs().max().item()
    tol = 2.0 * err_plain + 1e-3
    print(f"{label}: {name}: max abs err {err:.6g} vs fp32 (tol {tol:.6g}; plain bf16 "
          f"{err_plain:.6g}; fp32 max {ref.abs().max().item():.6g})", flush=True)
    check(bool(torch.isfinite(gpu).all()), f"{name}: non-finite values")
    check(err <= tol, f"{name}: error {err} > {tol}")
    return tol


def token_gate(torch, name: str, vq, lat, vq32, lat32, tol: float) -> None:
    """The card's tokens (the search kernel on the card's latents) equal the
    plain search on the same latents on the card, exactly; their agreement
    with the fp32 CPU tokens is gated at 99% on the rows whose fp32 top-2
    gap exceeds what a latent error of `tol` per element can move."""
    from fourm_torch.kernels import vq_codebook as vc

    B, D = lat.shape[0], lat.shape[-1]
    tokens = vq.quantize(lat.reshape(B, -1, D))[1].reshape(-1)
    flat, embed, _ = vq.quantize.search_inputs(lat.reshape(B, -1, D))
    cosine = vq.quantize.use_cosine_sim
    plain = (vc.nearest_code_cosine_plain if cosine else vc.nearest_code_plain)(flat, embed)
    check(torch.equal(tokens, plain), f"{name}: tokens differ from the plain search on the "
                                      f"card's latents at {int((tokens != plain).sum())} rows")
    ref = vq32.quantize(lat32.reshape(B, -1, D))[1].reshape(-1)
    f32, e32, _ = vq32.quantize.search_inputs(lat32.reshape(B, -1, D))
    f64, e64 = f32.double(), e32.double()
    delta = tol * D ** 0.5  # the largest latent error, as a vector norm
    if cosine:
        dist = f64 @ e64.t()
        move = 4 * delta / lat32.reshape(-1, D).double().norm(dim=-1)
    else:
        dist = -torch.cdist(f64, e64).square()
        move = 4 * delta * e64.norm(dim=-1).max() * torch.ones(len(f64), dtype=torch.float64)
    top2 = dist.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > move
    same = tokens.cpu() == ref
    agree = same.float().mean().item()
    n = int(decided.sum())
    agree_decided = same[decided].float().mean().item() if n else 1.0
    print(f"vq parity: {name}: tokens equal the plain search on the card's latents ({len(tokens)} "
          f"rows); agreement with fp32 CPU tokens {agree:.6f}, {agree_decided:.6f} on the {n} "
          f"rows whose fp32 top-2 gap exceeds the latent tolerance's effect"
          + ("" if n else " (no row qualifies: the gate holds nothing)"), flush=True)
    check(agree_decided >= 0.99, f"{name}: agreement {agree_decided} < 0.99 on decided rows")


def cpu_copies(model, build) -> dict:
    """The card model's weights in build(dtype)'s module on the CPU, for
    dtype float32 and bfloat16."""
    state = {k: v.float().cpu() for k, v in model.state_dict().items()}
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[dtype] = build(dtype)
        out[dtype].load_state_dict(state)
    return out


def vq_parity_phase(torch, models, x) -> None:
    """Phase 7: batch 2 on the card against the same weights on the CPU."""
    from fourm_torch.vq import TEACHER_PRESETS, VQ, ViTTeacher

    xb = x[:2]
    rgb = cpu_copies(models["rgb"], lambda dt: VQ(**dict(VQ_RGB, dtype=dt), device="cpu"))
    lat = models["rgb"].latents(xb)
    ref = {dt: m.latents(xb.cpu()).float() for dt, m in rgb.items()}
    tol = latent_gate(torch, "RGB tokenizer latents B=2", lat.float().cpu(), ref["float32"],
                      ref["bfloat16"])
    token_gate(torch, "RGB tokenizer", models["rgb"], lat, rgb["float32"], ref["float32"], tol)

    teacher = cpu_copies(models["teacher"], lambda dt: ViTTeacher(
        **TEACHER_PRESETS["CLIP-B16"], dtype=dt, device="cpu"))
    feat = models["teacher"](xb)
    fref = {dt: m(xb.cpu()).float() for dt, m in teacher.items()}
    latent_gate(torch, "CLIP-B16 teacher features B=2", feat.float().cpu(), fref["float32"],
                fref["bfloat16"])

    # the CLIP tokenizer on one input for all three runs: the fp32 features
    clip = cpu_copies(models["clip"], lambda dt: VQ(**dict(VQ_CLIP, dtype=dt), device="cpu"))
    f32 = fref["float32"]
    lat = models["clip"].latents(f32.cuda())
    ref = {dt: m.latents(f32).float() for dt, m in clip.items()}
    tol = latent_gate(torch, "CLIP tokenizer latents B=2", lat.float().cpu(), ref["float32"],
                      ref["bfloat16"])
    token_gate(torch, "CLIP tokenizer", models["clip"], lat, clip["float32"], ref["float32"], tol)


def train_model(torch, device: str, dtype: str = "bfloat16", seed=0, **overrides):
    """bench.py's train model (4M-B mod-7) with fp32 master weights from a
    seeded generator (none with seed None); `dtype` is the compute dtype."""
    from fourm_torch.models import FourM, create_fourm_config, init_weights
    from fourm_torch.utils.synthetic import MOD7_DECODER_MODALITIES, MOD7_MODALITIES

    cfg = create_fourm_config(TRAIN_MODEL, MOD7_MODALITIES, MOD7_DECODER_MODALITIES, dtype=dtype,
                              **overrides)
    with torch.device(device):
        model = FourM(cfg)
    return model if seed is None else init_weights(model, seed)


def train_batch(torch, B: int, seed: int, device: str):
    from fourm_torch.utils.synthetic import MOD7_MODALITIES, synthetic_mod_batch, to_torch

    return to_torch(synthetic_mod_batch(MOD7_MODALITIES, B, TRAIN_TOKENS, TRAIN_TOKENS,
                                        seed=seed), device)


def train_kernel_cases(torch, rn, gen, model):
    """The train step's kernels at its shapes: attention_train forward and
    backward at B = 32, 12 heads, N = M = 128 under a key bias (the encoder
    self- and the decoder cross-attention) and a full (B, 1, N, M) bias (the
    decoder self-attention); fused_adamw over the 256 leaves of `model`, the
    4M-B mod-7 tree. Then their options off the path, and the backward at N
    = M = 512 (the JAX gate's limit) and at N = 384, M = 200 (two key-tile
    CTAs: the dq partials and their sum), with faults. Returns (cases,
    variants, fault variants)."""
    import torch.nn.functional as F

    from fourm_torch.kernels import attention_train as at
    from fourm_torch.kernels import fused_adamw as fa
    from fourm_torch.utils.optim import weight_decay_mask

    dev, bf = "cuda", torch.bfloat16
    B, H, N, Dh = TRAIN_BATCH, 12, TRAIN_TOKENS, 64
    neg = torch.finfo(torch.float32).min
    src = "fourm_torch/kernels/csrc/attention_train.cu"
    fwd_at = "fourm_tpu/kernels/attention_bwd.py:161"
    bwd_at = "fourm_tpu/kernels/attention_bwd.py:193"
    qt = 64  # query rows of a backward ring stage (csrc/attention_train.cu)

    def bias_of(mode, B, N, M):
        if mode == "none":
            return None
        bias = torch.where(torch.rand(B, 1, 1 if mode == "key" else N, M, generator=gen,
                                      device=dev) < 0.3, neg, 0.0)
        if mode == "key":
            bias[0] = neg  # a batch row whose keys are all masked
        else:
            bias[:, :, 0] = neg  # a query row with no key
        return bias

    def problem(mode, N, M, B=B):
        q, do = rn(B, H, N, Dh), rn(B, H, N, Dh)
        k, v = rn(B, H, M, Dh), rn(B, H, M, Dh)
        return q, k, v, bias_of(mode, B, N, M), do

    def bias_bytes(bias):
        return 0 if bias is None else bias.numel() * 4

    def bwd_fp32(q, k, v, bias, o, do, cut=None, with_d=True, stats=None, d_shift=0,
                 dq_keys=None):
        """The twin's backward in fp32 with its roundings, for the faults:
        without the D term, with the key tiles from `cut` on left out, with
        p from the kernel's log2-unit `stats` read as natural units (rows
        with an unmasked key), with D of the query tile `d_shift` tiles on,
        or with dq from the first `dq_keys` keys only."""
        scale = Dh ** -0.5
        s = q.float() @ k.float().transpose(-1, -2) * scale
        if bias is not None:
            s = s + bias
        p = torch.softmax(s, -1)
        if stats is not None:
            live = stats[..., :1] > -1e29
            p = torch.where(live, torch.exp(torch.where(live, s - stats[..., :1], 0.0))
                            * stats[..., 1:], p)
        dp = do.float() @ v.float().transpose(-1, -2)
        d = (do.float() * o.float()).sum(-1, keepdim=True) if with_d else 0.0
        if d_shift:
            d = d.roll(-d_shift * qt, dims=2)
        ds, pb = (p * (dp - d)).to(bf).float(), p.to(bf).float()
        if cut is not None:
            ds[..., cut:], pb[..., cut:] = 0.0, 0.0
        keys = slice(None) if dq_keys is None else slice(0, dq_keys)
        return {"dq": ds[..., keys] @ k.float()[:, :, keys] * scale,
                "dk": ds.transpose(-1, -2) @ q.float() * scale,
                "dv": pb.transpose(-1, -2) @ do.float()}

    def stale_stages(t, tiles=2):
        """t (B, H, N, ...) with every query tile from the third on replaced
        by the one `tiles` tiles back: a ring stage its TMA never refilled."""
        out = t.clone()
        out[:, :, tiles * qt:] = t[:, :, :t.shape[2] - tiles * qt]
        return out

    def fwd_case(mode):
        q, k, v, bias, _ = problem(mode, N, N)
        mask = None if bias is None else bias.to(bf)

        def faults():
            p = torch.softmax(q.float() @ k.float().transpose(-1, -2) * Dh ** -0.5 + bias, -1)
            cut = at.attention_train_fwd_plain(q, k[:, :, :64], v[:, :, :64], bias[..., :64])
            return (p.to(bf).float() @ v.float(), {"last key tile left out": cut.float()},
                    {"last key tile left out"})

        return dict(
            run=lambda: at.attention_train_fwd(q, k, v, bias)[0],
            plain=lambda: at.attention_train_fwd_plain(q, k, v, bias), faults=faults,
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
            flops=4 * B * H * N * N * Dh,
            bytes=4 * B * H * N * Dh * 2 + B * H * N * 8 + bias_bytes(bias), path="train",
            shape=f"q, k, v (B={B}, 12, N=M={N}, 64), {mode} bias "
                  f"{tuple(bias.shape)}, o bf16 + row statistics fp32")

    def bwd_case(mode):
        q, k, v, bias, do = problem(mode, N, N)
        o, stats = at.attention_train_fwd(q, k, v, bias)
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias.to(bf))

        def run():
            out = at.attention_train_bwd(q, k, v, bias, o, stats, do)
            return dict(zip(("dq", "dk", "dv"), out))

        def plain():
            return dict(zip(("dq", "dk", "dv"), at.attention_train_bwd_plain(q, k, v, bias, o, do)))

        def faults():
            right = bwd_fp32(q, k, v, bias, o, do)
            wrong = {"D term left out": bwd_fp32(q, k, v, bias, o, do, with_d=False),
                     "dk without its scale": {"dk": right["dk"] * Dh ** 0.5},
                     "last key tile left out": bwd_fp32(q, k, v, bias, o, do, cut=64),
                     "statistics (log2 units) read as natural units":
                         bwd_fp32(q, k, v, bias, o, do, stats=stats),
                     "D from the other query tile": bwd_fp32(q, k, v, bias, o, do, d_shift=1)}
            return right, wrong, set(wrong)

        return dict(
            run=run, plain=plain, faults=faults,
            library=lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True),
            flops=10 * B * H * N * N * Dh,  # s, dp, dv, dq, dk: five products
            bytes=8 * B * H * N * Dh * 2 + B * H * N * 8 + bias_bytes(bias), path="train",
            shape=f"q, k, v, o, do (B={B}, 12, N=M={N}, 64), {mode} bias {tuple(bias.shape)}"
                  " -> dq, dk, dv")

    # fused_adamw: the model's leaves laid out in flat buffers (each leaf at a
    # 256-byte boundary, as the allocator places parameters), so that the
    # kernel and the twin start from the same values and compare whole
    params = [p.detach() for _, p in model.named_parameters()]
    decay = list(weight_decay_mask(model).values())
    check(len(params) == TRAIN_LEAVES and sum(p.numel() for p in params) == TRAIN_PARAMS,
          f"train tree: {len(params)} leaves, {sum(p.numel() for p in params)} parameters")
    sizes = [p.numel() for p in params]
    offsets = np.cumsum([0] + [-(-n // 64) * 64 for n in sizes])
    total = int(offsets[-1])

    def leaves(flat):
        return [flat[int(o):int(o) + n].view(p.shape) for o, n, p in zip(offsets, sizes, params)]

    def flat_of(fill):
        flat = torch.zeros(total, device=dev)
        for leaf, value in zip(leaves(flat), fill):
            leaf.copy_(value)
        return flat

    p0 = flat_of(params)
    g = torch.randn(total, generator=gen, device=dev) * 1e-2
    m0 = torch.randn(total, generator=gen, device=dev) * 1e-3
    v0 = torch.rand(total, generator=gen, device=dev) * 1e-5
    bufs = {who: [torch.empty_like(p0) for _ in range(3)] for who in ("kernel", "twin")}
    views = {who: [leaves(t) for t in ts] for who, ts in bufs.items()}
    g_leaves = leaves(g)
    tables = {}  # one per list of decay flags, as an optimizer holds one
    norm = torch.linalg.vector_norm(g).reshape(1)
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.05

    def adam_step(who, count, dec, clip=None):
        s = fa.adamw_scalars(count, 1e-3, b1, b2, eps, wd)
        grad_norm = None if clip is None else norm
        ps, ms, vs = views[who]
        if who == "kernel":
            if tuple(dec) not in tables:
                tables[tuple(dec)] = fa.AdamwTable(ps, ms, vs, dec)
            fa.fused_adamw(ps, g_leaves, ms, vs, dec, s, grad_norm, clip, tables[tuple(dec)])
        else:
            fa.fused_adamw_plain(ps, g_leaves, ms, vs, dec, s, grad_norm, clip)

    def adam_held(who, count, dec, clip=None):
        def go():
            for buf, start in zip(bufs[who], (p0, m0, v0)):
                buf.copy_(start)
            adam_step(who, count, dec, clip)
            return dict(zip("pmv", bufs[who]))
        return go

    lib_p = [torch.nn.Parameter(t.clone()) for t in leaves(p0)]
    for p, gl in zip(lib_p, leaves(g)):
        p.grad = gl
    library = torch.optim.AdamW(
        [{"params": [p for p, d in zip(lib_p, decay) if d]},
         {"params": [p for p, d in zip(lib_p, decay) if not d], "weight_decay": 0.0}],
        lr=1e-3, betas=(b1, b2), eps=eps, weight_decay=wd, fused=True)
    no_decay = [False] * len(decay)
    n = TRAIN_PARAMS
    adam = dict(run=lambda: adam_step("kernel", 0, decay),
                plain=lambda: adam_step("twin", 0, decay),
                held_run=adam_held("kernel", 0, decay), held_plain=adam_held("twin", 0, decay),
                exact=True, library=library.step, path="train",
                flops=16 * n, peak=PEAK_FP32_FLOPS, bytes=7 * 4 * n,
                shape=f"{len(params)} leaves, {n} fp32 parameters (4M-B mod-7), decay mask of "
                      f"the 4M rules, t = 1, one launch")
    cases = [("attention_train_fwd", fwd_at, ATTENTION_CU, fwd_case("key")),
             ("attention_train_fwd@full", fwd_at, ATTENTION_CU, fwd_case("full")),
             ("attention_train_bwd", bwd_at, src, bwd_case("key")),
             ("attention_train_bwd@full", bwd_at, src, bwd_case("full")),
             ("fused_adamw", "fourm_tpu/kernels/fused_adamw.py:73",
              "fourm_torch/kernels/csrc/fused_adamw.cu", adam)]

    # options the train step does not take, correctness only: no bias,
    # softmax1, ragged and short tiles (the kernels' row and key edges);
    # AdamW at t = 1000, with decay off, and with the global-norm clip engaged
    def attn_variant(mode, N, M, zero_attn=False, B=4):
        q, k, v, bias, do = problem(mode, N, M, B)
        o, stats = at.attention_train_fwd(q, k, v, bias, zero_attn)
        what = f"{mode} bias, N={N}, M={M}" + (", softmax1" if zero_attn else "")
        return [
            (f"attention_train_fwd, {what}", lambda: at.attention_train_fwd(
                q, k, v, bias, zero_attn)[0],
             lambda: at.attention_train_fwd_plain(q, k, v, bias, zero_attn)),
            (f"attention_train_bwd, {what}",
             lambda: dict(zip(("dq", "dk", "dv"), at.attention_train_bwd(q, k, v, bias, o, stats,
                                                                         do))),
             lambda: dict(zip(("dq", "dk", "dv"), at.attention_train_bwd_plain(
                 q, k, v, bias, o, do, zero_attn))))]

    variants = [*attn_variant("none", N, N, B=B), *attn_variant("key", N, N, True, B=B),
                *attn_variant("full", N, N, True, B=B), *attn_variant("full", 100, 77),
                *attn_variant("key", 5, 200), *attn_variant("none", 200, 5, True),
                *attn_variant("full", 63, 65), *attn_variant("key", 129, 1, True)]

    # the backward past the train step's tiles, held with faults: N = M = 512
    # (eight query tiles through the two-stage ring: a stale stage) and N =
    # 384, M = 200 (two key-tile CTAs, whose dq partials a second pass sums)
    def bwd_fault_variant(mode, N, M, B=8):
        q, k, v, bias, do = problem(mode, N, M, B)
        o, stats = at.attention_train_fwd(q, k, v, bias)

        def faults():
            right = bwd_fp32(q, k, v, bias, o, do)
            wrong = {}
            if N > 2 * qt:
                rows = [stale_stages(t) for t in (q, o, do)]
                sb = bias if mode != "full" else stale_stages(bias)
                stale = bwd_fp32(rows[0], k, v, sb, rows[1], rows[2])
                wrong["each query tile from the third on read from two tiles back (a stale "
                      "Q/dO ring stage)"] = stale
            if M > 128:
                wrong["dq of the first key tile (128 keys) only"] = {
                    "dq": bwd_fp32(q, k, v, bias, o, do, dq_keys=128)["dq"]}
            return right, wrong, set(wrong)

        return (f"attention_train_bwd, {mode} bias, B={B}, N={N}, M={M}",
                lambda: dict(zip(("dq", "dk", "dv"),
                                 at.attention_train_bwd(q, k, v, bias, o, stats, do))),
                lambda: dict(zip(("dq", "dk", "dv"),
                                 at.attention_train_bwd_plain(q, k, v, bias, o, do))),
                faults)

    fault_variants = [bwd_fault_variant("key", 512, 512), bwd_fault_variant("full", 384, 200)]
    for count, dec, clip, what in ((999, decay, None, "t = 1000"),
                                   (0, no_decay, None, "decay off, t = 1"),
                                   (999, no_decay, None, "decay off, t = 1000"),
                                   (0, decay, 0.5 * norm.item(), "global-norm clip engaged")):
        variants.append((f"fused_adamw, {what}", adam_held("kernel", count, dec, clip),
                         adam_held("twin", count, dec, clip), True))
    return cases, variants, fault_variants


def deterministic_check(torch, rn, gen) -> None:
    """attention_train_bwd twice on the same inputs, bit for bit: at the train
    step's shape under both biases, and past one CTA's 128 keys (the dq
    partials and their sum in key-tile order)."""
    from fourm_torch.kernels import attention_train as at

    neg = torch.finfo(torch.float32).min
    for B, N, M, full in ((TRAIN_BATCH, TRAIN_TOKENS, TRAIN_TOKENS, False),
                          (TRAIN_BATCH, TRAIN_TOKENS, TRAIN_TOKENS, True), (8, 384, 200, True)):
        q, do, k, v = rn(B, 12, N, 64), rn(B, 12, N, 64), rn(B, 12, M, 64), rn(B, 12, M, 64)
        bias = torch.where(torch.rand(B, 1, N if full else 1, M, generator=gen, device="cuda")
                           < 0.3, neg, 0.0)
        o, stats = at.attention_train_fwd(q, k, v, bias)
        first = at.attention_train_bwd(q, k, v, bias, o, stats, do)
        second = at.attention_train_bwd(q, k, v, bias, o, stats, do)
        same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
        print(f"deterministic attention_train_bwd, {'full' if full else 'key'} bias, B={B}, "
              f"N={N}, M={M}: dq, dk, dv bit-identical over two runs: {same}", flush=True)
        check(all(same), f"attention_train_bwd is not deterministic at N={N}, M={M}")


def train_kernel_phase(torch, card: str):
    """Phase 8: the train step's kernels against their twins, as phase 2;
    fused_adamw exactly (bit for bit); the backward's faults past the train
    step's tiles and its determinism; then phase 2's rows of the attention.cu
    kernel, whose body the forward shares, re-timed beside it."""
    gen, rn, key_bias = random_makers(torch, 2)
    model = train_model(torch, "cuda")
    cases, variants, fault_variants = train_kernel_cases(torch, rn, gen, model)
    results = time_cases(torch, cases, card)
    hold_variants(torch, variants)
    for name, run, plain, faults in fault_variants:
        parts = held(torch, name, run, plain, faults)
        print(f"variant {name}: " + "; ".join(f"{p} max_abs_err {e:.6g} (tol {t:.6g})"
                                              for p, (e, t) in parts.items()), flush=True)
    deterministic_check(torch, rn, gen)
    g64 = [torch.rand(64, generator=gen, device="cuda") + 0.5,
           torch.randn(64, generator=gen, device="cuda") * 0.1] * 2
    for name, _replaces, _source, c in attention_rows(torch, rn, gen, key_bias, g64):
        held(torch, name, c["run"], c["plain"])
        print(f"retime {name} (phase 2's row, beside the train step's forward): "
              f"{time_ms(torch, c['run'], 10):.4f} ms, library "
              f"{time_ms(torch, c['library'], 10):.4f} ms; {card}", flush=True)
    return results


def train_step_flops(model, batch) -> float:
    """Matmul FLOPs of one train step: 3 x the forward's (the backward's
    products are twice the forward's), the forward summed over the raw-RGB
    patch projection, 12 encoder blocks (qkv, proj, 4 N^2 D of attention,
    the SwiGLU MLP), the context projection, 12 decoder blocks
    (self-attention as the encoder's, cross-attention q, kv over the
    encoder's N tokens, proj and 4 N M D, the MLP) and each target
    modality's logits over its loss bucket."""
    cfg = model.config
    D, B = cfg.dim, next(iter(batch.values()))["tensor"].shape[0]
    N = M = TRAIN_TOKENS
    hidden = model.encoder[0].mlp.fc1.weight.shape[0]
    mlp = 3 * 2 * D * hidden
    patches = model.encoder_embeddings["rgb@224"].proj.weight
    n_patches = batch["rgb@224"]["tensor"][0].numel() // patches.shape[1]
    fwd = 2 * n_patches * patches.numel()
    fwd += cfg.encoder_depth * (N * (2 * 4 * D * D + mlp) + 4 * N * N * D)
    fwd += 2 * N * D * D
    fwd += cfg.decoder_depth * (M * (2 * 4 * D * D + mlp) + 4 * M * M * D
                                + 2 * M * D * 2 * D + 2 * N * D * 2 * D + 4 * M * N * D)
    for mod in cfg.decoder_modalities:
        cap = min(model._decoder_stream_length(mod, batch), M)
        fwd += 2 * cap * D * cfg.spec(mod).vocab_size
    return 3.0 * fwd * B


def train_phase(torch, card: str):
    """Phase 9: bench.py's train step at full width on the card through the
    public entry points: exact launch counts of one step, samples/s (median
    of 10 steps after 2 warm-up steps) and its share of the bf16 peak, and
    a falling, finite loss over the steps on one fixed batch at lr 1e-3."""
    from fourm_torch import kernels
    from fourm_torch.parallel import build_train_step, init_train_state
    from fourm_torch.utils.optim import constant_schedule, create_optimizer

    model = train_model(torch, "cuda")
    tx = create_optimizer(model, constant_schedule(1e-3), weight_decay=0.05, betas=(0.9, 0.95))
    state = init_train_state(model, tx)  # the card, by default
    step = build_train_step(model, tx, TRAIN_TOKENS, TRAIN_TOKENS)
    batch = train_batch(torch, TRAIN_BATCH, 0, "cuda")
    losses, times = [], []

    def run():
        nonlocal state
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        return metrics

    kernels.reset_launch_counts()
    metrics = run()
    launches = kernels.launch_counts()
    expected = {k: PER_TRAIN_STEP.get(k, 0) for k in launches}
    check(launches == expected, f"train step: launch counts {launches} != {expected}")
    check(set(metrics) == {"loss", "grad_norm"} | {f"loss_{m}" for m in model.config
                                                   .decoder_modalities},
          f"train step: metrics {sorted(metrics)}")
    for _ in range(12):
        run()
    check(all(np.isfinite(losses)), f"train step: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"train step: the loss did not fall: {losses}")
    sec = float(np.median(times[3:]))
    flops = train_step_flops(model, batch)
    print(f"train step: 4M-B mod-7 ({TRAIN_MODEL}, {TRAIN_PARAMS} fp32 parameters in "
          f"{TRAIN_LEAVES} leaves, bf16 compute), B={TRAIN_BATCH}, {TRAIN_TOKENS}+{TRAIN_TOKENS} "
          f"tokens: median {sec * 1e3:.4f} ms per step over 10 after 2 warm-up (range "
          f"{min(times[3:]) * 1e3:.4f}-{max(times[3:]) * 1e3:.4f}), "
          f"{TRAIN_BATCH / sec:.4f} samples/s; "
          f"{flops / 1e9:.2f} GFLOP per step (3 x forward matmuls), {flops / sec / 1e12:.4f} "
          f"TFLOP/s = {flops / sec / PEAK_BF16_FLOPS:.4f} of 989 TFLOP/s; {card}", flush=True)
    print(f"train step: losses over 13 steps on one batch at lr 1e-3: "
          f"{', '.join(f'{x:.4f}' for x in losses)}; grad_norm {float(metrics['grad_norm']):.6g}; "
          f"{card}", flush=True)
    print(f"launches {json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    del state, model, tx, step
    return launches


def train_parity_phase(torch, card: str) -> None:
    """Phase 9b: one train step at batch 2 on the card (kernels, bf16)
    against the same weights on the CPU in fp32 and in bf16 (plain twins):
    the loss, the gradients as a whole and every gradient leaf within 2 x
    (the plain bf16 error) + 1e-3; the card's new parameters and moments
    equal to the AdamW twin applied on the card to the card's own gradients.
    Then a planted fault, the cross-attention cores' dq zeroed (q detached),
    must fail the leaf gate."""
    from fourm_torch.kernels import fused_adamw as fa
    from fourm_torch.ops.transformer import CrossAttention
    from fourm_torch.parallel import build_train_step, init_train_state
    from fourm_torch.utils.optim import constant_schedule, create_optimizer

    start = {k: v.cpu() for k, v in train_model(torch, "cuda", seed=1).state_dict().items()}

    def card_step(check_update: bool):
        """One step at batch 2 on the card from `start`: (loss, grads on the
        CPU), the update held to the AdamW twin when asked."""
        model = train_model(torch, "cuda", seed=None)
        model.load_state_dict(start)
        tx = create_optimizer(model, constant_schedule(1e-3), weight_decay=0.05,
                              betas=(0.9, 0.95))
        state = init_train_state(model, tx)
        names, params = [n for n, _ in tx.named_params()], tx.params()

        def moments():
            return [tx.mu[n] for n in names], [tx.nu[n] for n in names]

        p_b, m_b, v_b = ([t.detach().clone() for t in ts] for ts in (params, *moments()))
        state, metrics = build_train_step(model, tx, TRAIN_TOKENS, TRAIN_TOKENS)(
            state, train_batch(torch, 2, 1, "cuda"))
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if check_update:
            s = fa.adamw_scalars(0, tx.schedule(0), tx.b1, tx.b2, tx.eps, tx.weight_decay)
            fa.fused_adamw_plain(p_b, grads, m_b, v_b, [tx.decay[n] for n in names], s)
            for what, ts, refs in zip("pmv", (params, *moments()), (p_b, m_b, v_b)):
                same = sum(int(torch.equal(t.detach(), r)) for t, r in zip(ts, refs))
                check(same == len(refs), f"train parity: {what} equals the twin's update in "
                                         f"{same} of {len(refs)} leaves")
        out = float(metrics["loss"]), [g.float().cpu() for g in grads], names
        del state, model, tx, grads, p_b, m_b, v_b
        torch.cuda.empty_cache()
        return out

    card_loss, grads, names = card_step(check_update=True)

    ref = {}
    for dtype in ("float32", "bfloat16"):
        cm = train_model(torch, "cpu", dtype=dtype, seed=None)
        cm.load_state_dict(start)
        loss, _ = cm(train_batch(torch, 2, 1, "cpu"), TRAIN_TOKENS, TRAIN_TOKENS)
        loss.backward()
        ref[dtype] = (loss.item(), [torch.zeros_like(p) if p.grad is None else p.grad
                                    for _, p in cm.named_parameters()])
        del cm

    def grad_err(gs):
        g32 = ref["float32"][1]
        num = sum(float((g.float().cpu() - r).square().sum()) for g, r in zip(gs, g32))
        return (num / sum(float(r.square().sum()) for r in g32)) ** 0.5

    def leaf_errs(gs):
        return [float((g.float().cpu() - r).norm() / r.norm().clamp_min(1e-30))
                for g, r in zip(gs, ref["float32"][1])]

    plain_leaf = leaf_errs(ref["bfloat16"][1])
    leaf_tol = [2.0 * e + 1e-3 for e in plain_leaf]
    grad_tol = 2.0 * grad_err(ref["bfloat16"][1]) + 1e-3

    def leaves_out(card_leaf):
        return [n for n, e, t in zip(names, card_leaf, leaf_tol) if not e <= t]

    loss32 = ref["float32"][0]
    for what, card_err, plain_err in (
            ("loss", abs(card_loss - loss32), abs(ref["bfloat16"][0] - loss32)),
            ("gradient, relative norm error", grad_err(grads), grad_err(ref["bfloat16"][1]))):
        tol = 2.0 * plain_err + 1e-3
        print(f"train parity: B=2 {what}: card {card_err:.6g} from fp32 (tol {tol:.6g}; plain "
              f"bf16 {plain_err:.6g}); fp32 loss {loss32:.6g}; {card}", flush=True)
        check(card_err <= tol, f"train parity: {what} {card_err} > {tol}")
    card_leaf = leaf_errs(grads)
    out = leaves_out(card_leaf)
    worst = max(range(len(names)), key=lambda i: card_leaf[i] / leaf_tol[i])
    print(f"train parity: per-leaf relative gradient error, each leaf within 2 x (plain bf16) + "
          f"1e-3: card max {max(card_leaf):.6g}, plain bf16 max {max(plain_leaf):.6g}; nearest "
          f"its tolerance {names[worst]} card {card_leaf[worst]:.6g} (tol {leaf_tol[worst]:.6g}, "
          f"plain {plain_leaf[worst]:.6g}); {len(names) - len(out)} of {len(names)} leaves "
          f"within; the card's update equals the AdamW twin's on its own gradients in all "
          f"{len(names)} leaves (p, m, v); {card}", flush=True)
    check(not out, f"train parity: gradient leaves beyond their tolerance: {out}")

    # the planted fault: q of every cross-attention core detached, so its dq
    # is zero; only decoder.*.cross_attn.q.weight is reached by nothing else
    project_q = CrossAttention.project_q
    CrossAttention.project_q = lambda self, x: project_q(self, x).detach()
    try:
        _, bad, _ = card_step(check_update=False)
    finally:
        CrossAttention.project_q = project_q
    out = leaves_out(leaf_errs(bad))
    hit = [n for n in names if n.endswith("cross_attn.q.weight")]
    bad_err = grad_err(bad)
    print(f"train parity: fault cross-attention dq zeroed: {len(out)} leaves beyond their "
          f"tolerance, {len(set(hit) & set(out))} of the {len(hit)} cross_attn.q leaves "
          f"(caught); whole-gradient error {bad_err:.6g} against its tol {grad_tol:.6g} "
          f"({'caught' if bad_err > grad_tol else 'missed'} by the global gate alone); {card}",
          flush=True)
    check(hit and set(hit) <= set(out),
          f"train parity: the zeroed cross-attention dq was not caught: {out}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from fourm_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(f"build: {_build.build_all():.2f} s for {len(_build.SOURCES)} sources "
          f"({', '.join(_build.SOURCES)})", flush=True)

    results = kernel_phase(torch, card)
    torch.cuda.empty_cache()  # each phase starts from an empty allocator cache
    results += xl_kernel_phase(torch, card)
    torch.cuda.empty_cache()
    results += narrow_kernel_phase(torch, card)
    torch.cuda.empty_cache()
    results += sr_kernel_phase(torch, card)
    torch.cuda.empty_cache()
    model = build_model(torch, "bfloat16", "cuda")
    out, launches, _ = chain_phase(torch, model, card)
    decode_bench(torch, model, out, card)
    decode_bench(torch, model, out, card, kv_quant="int8")
    cpu = cpu_models(torch, model)
    parity_phase(torch, model, out, cpu)
    decode_parity_phase(torch, model, out, cpu)
    del cpu
    bundles = build_tokenizers(torch)
    dec, decode_launches = decode_phase(torch, model, out, bundles, card)
    uvit_launches, uvit = uvit_decode_phase(torch, card)
    decode_tokens_parity_phase(torch, bundles, uvit, out, dec)
    sr_model, sr_out, sr_chain_launches = sr_phase(torch, card)
    resolve_launches = super_resolve_phase(torch, card, sr_model, model, out)
    del sr_model
    torch.cuda.empty_cache()
    decode448_launches, uvit448_launches = decode448_phase(torch, model, sr_out, bundles, uvit,
                                                           card)
    sr_parity_phase(torch, sr_out)
    api_launches = generate_api_phase(torch, model, card)
    del model, out, bundles, uvit, dec, sr_out
    torch.cuda.empty_cache()
    xl_launches, int8_launches = xl_phase(torch, card)
    torch.cuda.empty_cache()
    narrow_launches = narrow_phase(torch, card)
    torch.cuda.empty_cache()
    fp32_phase(torch, card)
    torch.cuda.empty_cache()
    results += vq_kernel_phase(torch, card)
    torch.cuda.empty_cache()
    vq_launches, vq_models, vq_x = vq_phase(torch, card)
    vq_parity_phase(torch, vq_models, vq_x)
    vq448_phase(torch, vq_models, card)
    del vq_models, vq_x
    torch.cuda.empty_cache()
    results += train_kernel_phase(torch, card)
    torch.cuda.empty_cache()
    train_launches = train_phase(torch, card)
    torch.cuda.empty_cache()
    train_parity_phase(torch, card)
    sr_paths = {"sr_chain": sr_chain_launches, "super_resolve": resolve_launches,
                "decode448": decode448_launches, "uvit_decode448": uvit448_launches}
    path_launches = dict(vq_launches, chain=launches, train=train_launches,
                         xl_chain=xl_launches, int8_chain=int8_launches, **narrow_launches,
                         **sr_paths, **api_launches)
    decode_paths = {"decode": decode_launches, "uvit_decode": uvit_launches}
    for r in results:  # each wrapper's launches on the path that runs it
        path, wrapper = r["path"], r.pop("wrapper")
        r["launches"] = path_launches[path][wrapper]
        r["decode_launches"] = {p: n[wrapper] for p, n in decode_paths.items()}
        r["sr_launches"] = {p: n[wrapper] for p, n in sr_paths.items()}
        check(r["launches"] > 0, f"{r['name']}: no launch on its path ({path})")

    print(f"total {time.perf_counter() - t_start:.1f} s; card: {card}", flush=True)
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
