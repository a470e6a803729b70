"""GenerationSampler: chained generation, PyTorch port.

Counterpart of fourm_tpu/generate/sampler.py (reference
fourm/models/generate.py:323-1273), in its fixed-shape form:
  * MaskGIT / ROAR decode over the target's FULL token grid with
    key-restricted self-attention (FourM.forward_generation_img), so every
    step of a target runs at one shape;
  * classifier-free guidance runs cond and uncond in one batch-doubled
    forward;
  * sequence targets decode autoregressively with per-layer KV caches and
    cross-attention K/V computed once at prefill, in a fixed-shape token
    loop with per-row EOS freezing; the finished sequence is spliced back
    into the target's input on the device (span merge);
  * the encoder stream is compacted to a host-computed bucket of valid
    tokens (`_encoder_budget`), with counts updated analytically per step.
The steps of one target run as one Python loop (the counterpart of the JAX
package's fused lax.scan / while_loop). Beside `generate`: `generate_iter`
(the same steps, yielding after each), `generate_multi_guided` (weighted
guidance by several conditions), `generate_sam_dense` (replicas merged into
one instance list) and `merge_sequences`, the host span merge the device
merges are held to. Randomness comes from one torch.Generator on the
model's device, seeded from `seed`; its draws are not those of jax.random,
so equality with the JAX package is tested where no draw matters (one ROAR
step per image target or MaskGIT, at temperature 0).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.modality_info import MODALITY_INFO
from ..kernels.decode_step import quantize_kv_decode
from ..ops.sampling import top_k_top_p_filtering_dynamic
from ..ops.token_select import select_tokens
from ..utils.text_tokenizer import get_sentinel_to_id_mapping, merge_span_masking
from .init_helpers import PAD_ID, S1_ID, expand_to_batch

# rows that are done only write PAD, so whether every row is done is read
# from the device once every this many tokens, not after each token
DONE_CHECK_EVERY = 16

IMG = "img"
SEQ = ("seq", "seq_token")
# an image step's default encoder budget: its own, from the current counts
OWN_BUDGET = object()


def _sample_traced_temp(gen: torch.Generator, logits: torch.Tensor, temperature: float):
    """Sample (..., V) logits at `temperature`; below 1e-9 it is argmax with
    probability 1 (reference sample_tokens, generate.py:361-370)."""
    logits = logits.float()
    if temperature < 1e-9:
        samples = logits.argmax(dim=-1)
        return samples, torch.ones(samples.shape, device=logits.device)
    probs = torch.softmax(logits / max(temperature, 1e-9), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    samples = torch.multinomial(flat, 1, generator=gen).reshape(probs.shape[:-1])
    return samples, probs.gather(-1, samples[..., None])[..., 0]


def _ranks_desc(scores: torch.Tensor) -> torch.Tensor:
    """ranks[i] = how many entries (index tie-break) precede i in descending
    score order."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.argsort(order, dim=-1)


def _use_cfg(cfg_scale, conds) -> bool:
    """Whether a step guides: a scalar scale other than 1 and conditions to
    empty (a list of scales is multi-condition guidance)."""
    return not isinstance(cfg_scale, (list, tuple)) and cfg_scale != 1.0 and len(conds) > 0


def _decoder_keys(still: torch.Tensor, scheme: str, num_select: int, gen: torch.Generator):
    """The target positions an image step's queries may attend to: for ROAR
    a random subset of num_select still-masked positions (the step's
    tokens), for MaskGIT every still-masked one."""
    if scheme != "roar":
        return still
    noise = torch.rand(still.shape, generator=gen, device=still.device)
    noise = noise.masked_fill(~still, float("-inf"))
    return (_ranks_desc(noise) < num_select) & still


def _accept(d_t, scheme: str, still, sa_valid, logits, temperature: float, num_select: int,
            top_k: float, top_p: float, gen: torch.Generator):
    """Sample a step's (B, N, V) logits and accept its tokens: ROAR's chosen
    subset, or MaskGIT's num_select most confident still-masked positions.
    Returns the target's new (tensor, input_mask, target_mask)."""
    if top_k or top_p:
        logits = top_k_top_p_filtering_dynamic(logits, top_k, top_p)
    samples, probs = _sample_traced_temp(gen, logits, temperature)
    samples = samples.to(d_t["tensor"].dtype)
    if scheme == "roar":
        accept = sa_valid
    else:
        conf = probs.masked_fill(~still, float("-inf"))
        accept = (_ranks_desc(conf) < num_select) & still
    return (torch.where(accept, samples, d_t["tensor"]), d_t["input_mask"] & ~accept,
            d_t["target_mask"] | accept)


def _empty_cond_tree(mod_dict, cond_mods: Sequence[str]):
    """Empty-modality transforms (generate.py:30-80) applied to the
    conditioning modalities: the CFG unconditional branch."""
    out = {m: dict(d) for m, d in mod_dict.items()}
    for mod in cond_mods:
        spec = MODALITY_INFO[mod]
        d = out[mod]
        if spec.type == IMG:
            d["input_mask"] = torch.ones_like(d["input_mask"])
        elif spec.type in SEQ:
            t = torch.zeros_like(d["tensor"])
            t[:, 0] = S1_ID
            t[:, 1] = S1_ID
            t[:, -1] = S1_ID + 1
            d["tensor"] = t
            im = torch.ones_like(d["input_mask"])
            im[:, 0] = False
            d["input_mask"] = im
        elif spec.type == "seq_emb":
            d["tensor"] = torch.zeros_like(d["tensor"])
            im = torch.ones_like(d["input_mask"])
            im[:, 0] = False
            d["input_mask"] = im
        else:
            raise ValueError(f"cannot empty modality type {spec.type}")
    return out


def _tree_concat(dicts):
    """Concatenate mod dicts along the batch axis."""
    return {mod: {k: torch.cat([d[mod][k] for d in dicts], 0) for k in dicts[0][mod]}
            for mod in dicts[0]}


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _on_device(mod_dict, dev):
    """A mod dict's arrays and tensors as tensors on `dev` (new dicts)."""
    return {m: {k: torch.as_tensor(v).to(dev) for k, v in d.items()} for m, d in mod_dict.items()}


def _head_sentinel(toks: torch.Tensor, is_sent: torch.Tensor, before: torch.Tensor):
    """The most recent sentinel at or before each position, `before` where
    none precedes it."""
    pos = torch.arange(toks.shape[1], device=toks.device)[None, :]
    last_pos = torch.cummax(torch.where(is_sent, pos, -1), dim=1).values
    return torch.where(last_pos >= 0, torch.gather(toks, 1, last_pos.clamp_min(0)), before)


def merge_empty_input(out_ids: torch.Tensor, L: int, sentinels: Tuple[int, ...],
                      span_sentinel: int):
    """Span merge when the target's input region was empty (fourm_tpu
    sampler.py:452-502): the merged sequence is the non-PAD tokens of every
    decoder segment headed by `span_sentinel`, the start marker heading
    segment 0 (a repeated sentinel continues its span, as the JAX package's
    split_by_sentinel appends). Returns (tensor (B, L) int32, input_mask, max valid count)."""
    toks = out_ids[:, 1:].long()
    start = out_ids[:, :1].long()
    sent = torch.tensor(sentinels, dtype=torch.int64, device=toks.device)
    is_sent = (toks[..., None] == sent).any(-1)
    head = _head_sentinel(toks, is_sent, start)
    keep = (toks != PAD_ID) & ~is_sent & (head == span_sentinel)
    n_keep = keep.sum(1)
    idx = select_tokens(~keep, min(L, toks.shape[1]))
    valid = torch.arange(idx.shape[1], device=toks.device)[None, :] < n_keep[:, None]
    merged = torch.where(valid, torch.gather(toks, 1, idx), PAD_ID).to(torch.int32)
    if L > merged.shape[1]:
        merged = torch.nn.functional.pad(merged, (0, L - merged.shape[1]), value=PAD_ID)
        valid = torch.nn.functional.pad(valid, (0, L - valid.shape[1]))
    return merged, ~valid, int(n_keep.max())


def merge_general(in_tensor: torch.Tensor, in_mask: torch.Tensor, out_ids: torch.Tensor,
                  L: int, sentinels: Tuple[int, ...], default_sentinel: int):
    """General span merge (fourm_tpu sampler.py:504-596, reference
    generate.py:550-626): walk the input tokens, copy non-sentinels, and
    expand each input sentinel into the decoder tokens, in order, whose most
    recent preceding sentinel is that one; an empty input acts as
    [default_sentinel]. Fixed shapes; returns (tensor (B, L) int32,
    input_mask, max valid count)."""
    dev = in_tensor.device
    B, T_in = in_tensor.shape
    T_dec = out_ids.shape[1]
    sent = torch.tensor(sentinels, dtype=torch.int64, device=dev)
    S = sent.shape[0]
    # the input tokens, valid first in their order
    in_tok = torch.gather(in_tensor, 1, select_tokens(in_mask, T_in)).long()
    n_in = (~in_mask).sum(1)
    col = torch.arange(T_in, device=dev)[None, :]
    in_tok = torch.where((n_in == 0)[:, None] & (col == 0), default_sentinel, in_tok)
    valid_in = col < n_in.clamp_min(1)[:, None]
    # each decoder token's head sentinel; per sentinel, its tokens in order
    toks = out_ids.long()
    is_pad_d = toks == PAD_ID
    is_sent_d = (toks[..., None] == sent).any(-1) & ~is_pad_d
    head = _head_sentinel(toks, is_sent_d, torch.full_like(toks, -1))
    keep_d = ~is_pad_d & ~is_sent_d & (head >= 0)
    mine = keep_d[:, None, :] & (head[:, None, :] == sent[None, :, None])  # (B, S, T_dec)
    dec_tab = torch.gather(toks[:, None, :].expand(B, S, T_dec), 2, select_tokens(~mine, T_dec))
    dec_cnt = mine.sum(-1)  # (B, S)
    # run length and exclusive start of each input position
    sent_match = in_tok[..., None] == sent  # (B, T_in, S)
    is_sent_i = sent_match.any(-1) & valid_in
    sent_j = sent_match.to(torch.uint8).argmax(-1)  # first match
    len_i = torch.where(valid_in, torch.where(is_sent_i, torch.gather(dec_cnt, 1, sent_j), 1), 0)
    start_i = torch.cumsum(len_i, 1) - len_i
    n_out = len_i.sum(1)
    # each output slot from the run that contains it
    o = torch.arange(L, device=dev)[None, None, :]
    contains = (start_i[:, :, None] <= o) & (o < (start_i + len_i)[:, :, None])  # (B, T_in, L)
    found = contains.any(1)
    i_of_o = contains.to(torch.uint8).argmax(1)  # (B, L)
    k = torch.arange(L, device=dev)[None, :] - torch.gather(start_i, 1, i_of_o)
    dec_val = dec_tab[torch.arange(B, device=dev)[:, None], torch.gather(sent_j, 1, i_of_o),
                      k.clamp(0, T_dec - 1)]
    val = torch.where(torch.gather(is_sent_i, 1, i_of_o), dec_val, torch.gather(in_tok, 1, i_of_o))
    merged = torch.where(found, val, PAD_ID).to(torch.int32)
    return merged, ~found, int(n_out.clamp_max(L).max())


class GenerationSampler:
    """Chained generation with a FourM model (its parameters held by the model).

    Usage:
      sampler = GenerationSampler(model, text_tokenizer)
      out = sampler.generate(mod_dict, schedule, seed=0)

    `text_tokenizer` (anything with `get_vocab()` and `token_to_id()`) gives
    the sentinel ids that the span merge of sequence targets needs.
    `kv_quant="int8"` quantizes every layer's cross K/V to int8 with
    per-(batch, head, channel) scales after each AR prefill (fourm_tpu
    sampler.py:109-129, :393-400): the decode steps then read half the
    bytes of the cross K/V stream, and tokens may differ from the bf16 run
    within the quantization error.
    """

    def __init__(self, model, text_tokenizer=None, top_k: float = 0.0, top_p: float = 0.0,
                 kv_quant: Optional[str] = None):
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant {kv_quant!r}")
        self.model = model
        self.text_tokenizer = text_tokenizer
        self.top_k = top_k
        self.top_p = top_p
        self.kv_quant = kv_quant
        # tokens decoded per sequence target in the last `generate` call
        self._ar_tokens: Dict[str, int] = {}

    def _init_valid_counts(self, mod_dict) -> Dict[str, int]:
        """Per-modality max (over batch) count of valid encoder tokens, taken
        once at the start of `generate`; later steps update it analytically."""
        counts: Dict[str, int] = {}
        for mod in self.model.config.encoder_modalities:
            if mod in mod_dict:
                m = _np(mod_dict[mod]["input_mask"])
                counts[mod] = int((~m).sum(axis=1).max())
        return counts

    def _encoder_budget(self, counts: Dict[str, int], mod_dict) -> Optional[int]:
        """Encoder-token budget: the valid count rounded up to 256, or None
        when that would not be shorter than the whole stream."""
        total = sum(mod_dict[mod]["input_mask"].shape[1]
                    for mod in self.model.config.encoder_modalities if mod in mod_dict)
        if not counts or total == 0:
            return None
        need = max(sum(counts.values()), 1)
        bucket = min(-(-need // 256) * 256, total)
        return None if bucket >= total else bucket

    @staticmethod
    def _group_schedule(schedule: List[dict]) -> List[List[dict]]:
        """Group consecutive img steps of the same (target, scheme, CFG
        conditions); each group runs as one loop."""
        groups: List[List[dict]] = []
        for step_info in schedule:
            spec = MODALITY_INFO[step_info["target_domain"]]
            is_list = isinstance(step_info.get("cfg_scale", 1.0), (list, tuple))
            key = (step_info["target_domain"], step_info.get("scheme"),
                   tuple(step_info.get("cfg_cond_domains", ())))
            if (spec.type == IMG and not is_list and groups and groups[-1] and
                    groups[-1][0].get("_group_key") == key):
                groups[-1].append(step_info)
            elif spec.type == IMG and not is_list:
                groups.append([{**step_info, "_group_key": key}])
            else:
                groups.append([step_info])
        return groups

    def _img_step(self, md_step, target_mod: str, scheme: str, cond_mods, use_cfg: bool,
                  num_select: int, temperature: float, cfg_scale: float, top_k: float,
                  top_p: float, enc_budget: Optional[int], gen: torch.Generator):
        """One MaskGIT / ROAR step (the body of the JAX package's
        _img_target_fn scan). Returns the target's new (tensor, input_mask,
        target_mask)."""
        d_t = md_step[target_mod]
        B = d_t["tensor"].shape[0]
        still = ~d_t["target_mask"]
        sa_valid = _decoder_keys(still, scheme, num_select, gen)
        if use_cfg:
            md = _tree_concat([md_step, _empty_cond_tree(md_step, cond_mods)])
            sa = torch.cat([sa_valid, sa_valid], 0)
        else:
            md, sa = md_step, sa_valid
        logits = self.model.forward_generation_img(md, target_mod, sa, enc_budget).float()
        if use_cfg:
            lc, lu = logits[:B], logits[B:]
            logits = lu + cfg_scale * (lc - lu)
        return _accept(d_t, scheme, still, sa_valid, logits, temperature, num_select, top_k,
                       top_p, gen)

    def _group_budget(self, counts: Dict[str, int], mod_dict, group: List[dict]):
        """The encoder budget of an image target's steps: that of its LAST
        step, when all of its accepted tokens are already encoder inputs, so
        that every step of the target runs at one shape."""
        target_mod = group[0]["target_domain"]
        end_counts = dict(counts)
        if target_mod in end_counts:
            cap = int(np.prod(mod_dict[target_mod]["input_mask"].shape[1:]))
            end_counts[target_mod] = min(
                end_counts[target_mod] + sum(int(s["num_tokens"]) for s in group), cap)
        return self._encoder_budget(end_counts, mod_dict)

    def _generate_one_step(self, mod_dict, step_info: dict, gen: torch.Generator,
                           top_k: Optional[float] = None, top_p: Optional[float] = None,
                           counts: Optional[Dict[str, int]] = None, text_tokenizer=None,
                           enc_budget=OWN_BUDGET):
        """One step of a schedule (fourm_tpu sampler.py:781-846): a MaskGIT /
        ROAR step of an image target, whose num_select accepted tokens then
        count as encoder inputs (capped at the grid size), or a whole
        sequence target, whose count becomes its merged length. An image
        step runs at `enc_budget` (None: the whole encoder stream), by
        default at its own budget from `counts` (from mod_dict when None,
        which costs a sync), as the JAX package's single step does."""
        top_k = self.top_k if top_k is None else top_k
        top_p = self.top_p if top_p is None else top_p
        if counts is None:
            counts = self._init_valid_counts(mod_dict)
        target_mod = step_info["target_domain"]
        kind = MODALITY_INFO[target_mod].type
        if kind in SEQ:
            return self._generate_seq_target(mod_dict, step_info, gen, top_k, top_p,
                                             counts=counts, text_tokenizer=text_tokenizer)
        if kind != IMG:
            raise ValueError(f"invalid target modality type {kind}")
        cfg_scale = step_info.get("cfg_scale", 1.0)
        conds = tuple(step_info.get("cfg_cond_domains", ()))
        # a list-valued (multi-condition) guidance step runs without CFG here,
        # as in the JAX package: generate_multi_guided serves it
        use_cfg = _use_cfg(cfg_scale, conds)
        num_select = int(step_info["num_tokens"])
        if enc_budget is OWN_BUDGET:
            enc_budget = self._encoder_budget(counts, mod_dict)
        d = mod_dict[target_mod]
        tensor, input_mask, target_mask = self._img_step(
            mod_dict, target_mod, step_info["scheme"].lower(), conds if use_cfg else (), use_cfg,
            num_select, float(step_info["temperature"]), float(cfg_scale) if use_cfg else 1.0,
            top_k, top_p, enc_budget, gen)
        mod_dict[target_mod] = {**d, "tensor": tensor, "input_mask": input_mask,
                                "target_mask": target_mask}
        if target_mod in counts:
            cap = int(np.prod(input_mask.shape[1:]))
            counts[target_mod] = min(counts[target_mod] + num_select, cap)
        return mod_dict

    def _generate_img_target(self, mod_dict, group: List[dict], gen: torch.Generator,
                             top_k: float, top_p: float, counts: Dict[str, int]):
        """All steps of one image target, at the group's encoder budget."""
        budget = self._group_budget(counts, mod_dict, group)
        for step_info in group:
            mod_dict = self._generate_one_step(mod_dict, step_info, gen, top_k, top_p, counts,
                                               enc_budget=budget)
        return mod_dict

    def _ar_decode(self, mod_dict, target_mod: str, cond_mods, use_cfg: bool, max_len: int,
                   temperature: float, cfg_scale: float, top_k: float, top_p: float,
                   enc_budget: Optional[int], gen: torch.Generator):
        """KV-cached autoregressive decoding of one sequence target, the
        JAX package's _ar_step_fn (sampler.py:357-448) as a Python loop over
        fixed shapes. Returns (out_ids (B, max_len) int32, length); the
        number of tokens decoded goes to self._ar_tokens[target_mod]."""
        model = self.model
        d_t = mod_dict[target_mod]
        tensor, target_mask = d_t["tensor"], d_t["target_mask"]
        B, T = tensor.shape
        dev = tensor.device
        # start token = first target-region token ([S_1]); eos = its last one
        tgt_ids = torch.gather(tensor, 1, select_tokens(target_mask, min(max_len, T)))
        n_valid = (~target_mask).sum(1)
        start = tgt_ids[:, 0].to(torch.int32)
        eos_tok = torch.gather(tgt_ids, 1, (n_valid - 1).clamp_min(0)[:, None])[:, 0]
        done = start == eos_tok
        # generate at most as many tokens as the target region holds, none if
        # every row is done: one host read per target, made before the
        # prefill is queued so that the host does not wait for it
        n_max, all_done0 = torch.stack([n_valid.max(), done.all().to(n_valid.dtype)]).tolist()
        bound = 0 if all_done0 else min(n_max, max_len - 1)
        md = _tree_concat([mod_dict, _empty_cond_tree(mod_dict, cond_mods)]) if use_cfg \
            else mod_dict
        cross_kvs, enc_mask, y_emb = model.ar_prefill(md, target_mod, max_len, enc_budget)
        if self.kv_quant == "int8":
            quantized = (quantize_kv_decode(k, v) for k, v in cross_kvs)
            cross_kvs = [((k, ks), (v, vs)) for k, ks, v, vs in quantized]
        caches = model.init_kv_caches(y_emb.shape[0], max_len)

        out = torch.zeros((B, max_len), dtype=torch.int32, device=dev)
        out[:, 0] = start
        # all_done[t] is True once every row is done after t tokens; the
        # loop reads it every DONE_CHECK_EVERY tokens, the length at the end
        all_done = torch.zeros(bound + 1, dtype=torch.bool, device=dev)
        all_done[0] = done.all()
        step_idx = torch.zeros(1, dtype=torch.int32, device=dev)
        tok = start
        t = 0
        while t < bound:
            if t > 0 and t % DONE_CHECK_EVERY == 0 and bool(all_done[t]):
                break
            tok_f = torch.cat([tok, tok]) if use_cfg else tok
            y_t = model.embed_target_token(target_mod, tok_f[:, None]) + y_emb[:, t:t + 1]
            y_out, caches = model.decode_one_token(y_t, caches, cross_kvs, enc_mask, step_idx)
            logits = model.mod_logits(target_mod, y_out)[:, 0].float()
            if use_cfg:
                lc, lu = logits[:B], logits[B:]
                logits = lu + cfg_scale * (lc - lu)
            if top_k or top_p:
                logits = top_k_top_p_filtering_dynamic(logits, top_k, top_p)
            sample, _ = _sample_traced_temp(gen, logits, temperature)
            sample = torch.where(done, PAD_ID, sample.to(torch.int32))  # freeze finished rows
            out[:, t + 1] = sample
            done = done | (sample == eos_tok)
            all_done[t + 1] = done.all()
            tok = sample
            step_idx += 1
            t += 1
        self._ar_tokens[target_mod] = t
        # the JAX loop stops at the first token after which every row is done
        finished = torch.nonzero(all_done[:t + 1])
        length = (int(finished[0, 0]) if finished.numel() else t) + 1
        return out, length

    def merge_sequences_device(self, mod_dict, out_ids, target_mod: str,
                               text_tokenizer=None) -> Dict:
        """Span merge for a target whose input region was empty (fourm_tpu
        sampler.py:598-617), on the device; one scalar comes to the host for
        the encoder budget."""
        tok = self._tokenizer(text_tokenizer, target_mod)
        sentinels = tuple(sorted(get_sentinel_to_id_mapping(tok).values()))
        L = (MODALITY_INFO[target_mod].resolved_max_tokens() + 1) * 2
        tensor, input_mask, n_valid = merge_empty_input(out_ids, L, sentinels,
                                                        tok.token_to_id("[S_1]"))
        return self._set_merged(mod_dict, target_mod, tensor, input_mask, n_valid)

    def merge_sequences_device_general(self, mod_dict, out_ids, target_mod: str,
                                       text_tokenizer=None) -> Dict:
        """General span merge into the existing input sequence (fourm_tpu
        sampler.py:619-641), on the device; one scalar comes to the host."""
        tok = self._tokenizer(text_tokenizer, target_mod)
        sentinels = tuple(sorted(get_sentinel_to_id_mapping(tok).values()))
        L = (MODALITY_INFO[target_mod].resolved_max_tokens() + 1) * 2
        d = mod_dict[target_mod]
        tensor, input_mask, n_valid = merge_general(d["tensor"], d["input_mask"], out_ids, L,
                                                    sentinels, tok.token_to_id("[S_1]"))
        return self._set_merged(mod_dict, target_mod, tensor, input_mask, n_valid)

    def merge_sequences(self, mod_dict, out_ids, target_mod: str, text_tokenizer=None) -> Dict:
        """Span merge on the host (fourm_tpu sampler.py:643-673, reference
        generate.py:550-626), the oracle the device merges are held to:
        each row's generated spans spliced into its input sequence (an empty
        input acts as [S_1]) by merge_span_masking, in the fixed
        (max_tokens + 1) * 2 layout, as tensors on the target's device."""
        tok = self._tokenizer(text_tokenizer, target_mod)
        sentinel_ids = set(get_sentinel_to_id_mapping(tok).values())
        default_sentinel = tok.token_to_id("[S_1]")
        d = mod_dict[target_mod]
        in_tensor, in_mask, out_ids = _np(d["tensor"]), _np(d["input_mask"]), _np(out_ids)
        B = in_tensor.shape[0]
        L = (MODALITY_INFO[target_mod].resolved_max_tokens() + 1) * 2
        tensor = np.full((B, L), PAD_ID, dtype=np.int32)
        input_mask = np.ones((B, L), dtype=bool)
        for b in range(B):
            inp = in_tensor[b][~in_mask[b]].tolist() or [default_sentinel]
            preds = [int(t) for t in out_ids[b] if t != PAD_ID]
            merged = merge_span_masking(inp, preds, sentinel_ids)[:L]
            tensor[b, :len(merged)] = merged
            input_mask[b, :len(merged)] = False
        dev = d["tensor"].device if isinstance(d["tensor"], torch.Tensor) else None
        return self._set_merged(mod_dict, target_mod, torch.from_numpy(tensor).to(dev),
                                torch.from_numpy(input_mask).to(dev),
                                int((~input_mask).sum(1).max()))

    def _tokenizer(self, text_tokenizer, target_mod: str):
        tok = text_tokenizer or self.text_tokenizer
        if tok is None:
            raise ValueError(f"sequence target {target_mod!r} needs a text tokenizer: its "
                             "sentinel ids drive the span merge")
        return tok

    def _set_merged(self, mod_dict, target_mod, tensor, input_mask, n_valid: int):
        B, L = tensor.shape
        self._last_merge_valid = n_valid
        mod_dict[target_mod] = {
            "tensor": tensor,
            "input_mask": input_mask,
            "target_mask": torch.ones((B, L), dtype=torch.bool, device=tensor.device),
            "decoder_attention_mask": torch.zeros((B, L), dtype=torch.int32,
                                                  device=tensor.device),
        }
        return mod_dict

    def _generate_seq_target(self, mod_dict, step_info: dict, gen: torch.Generator,
                             top_k: float, top_p: float, counts: Dict[str, int],
                             text_tokenizer=None):
        """One sequence target: AR decode, then the span merge on the device
        (the sequence branch of the JAX package's _generate_one_step,
        sampler.py:815-843). The target's encoder count becomes its merged
        length."""
        target_mod = step_info["target_domain"]
        self._tokenizer(text_tokenizer, target_mod)  # fail before decoding
        cfg_scale = step_info.get("cfg_scale", 1.0)
        conds = tuple(step_info.get("cfg_cond_domains", ()))
        use_cfg = _use_cfg(cfg_scale, conds)
        max_len = min(MODALITY_INFO[target_mod].resolved_max_tokens(),
                      int(mod_dict[target_mod]["tensor"].shape[1]))
        out_ids, _ = self._ar_decode(
            mod_dict, target_mod, conds if use_cfg else (), use_cfg, max_len,
            float(step_info["temperature"]), float(cfg_scale) if use_cfg else 1.0, top_k,
            top_p, self._encoder_budget(counts, mod_dict), gen)
        # an empty sequence target starts with [S_1] as its one input token,
        # so the chain takes the general merge; the empty-input one serves a
        # truly empty input region
        if counts.get(target_mod, None) == 0:
            mod_dict = self.merge_sequences_device(mod_dict, out_ids, target_mod, text_tokenizer)
        else:
            mod_dict = self.merge_sequences_device_general(mod_dict, out_ids, target_mod,
                                                           text_tokenizer)
        if target_mod in counts:
            counts[target_mod] = self._last_merge_valid
        return mod_dict

    def _start(self, mod_dict, seed: Optional[int]):
        """A run's generator (seeded from `seed`, 0 when None), the valid
        counts and the mod dict as tensors on the model's device."""
        dev = self.model.device
        gen = torch.Generator(device=dev).manual_seed(0 if seed is None else int(seed))
        counts = self._init_valid_counts(mod_dict)
        self._ar_tokens = {}
        return gen, counts, _on_device(mod_dict, dev)

    def generate(self, mod_dict, schedule: List[dict], seed: Optional[int] = None,
                 top_k: Optional[float] = None, top_p: Optional[float] = None,
                 text_tokenizer=None):
        """Run a chained generation schedule (reference generate.py:1028-1095).
        Returns the mod dict with every target filled in, as tensors on the
        model's device."""
        top_k = self.top_k if top_k is None else top_k
        top_p = self.top_p if top_p is None else top_p
        gen, counts, mod_dict = self._start(mod_dict, seed)
        with torch.inference_mode():
            for group in self._group_schedule(schedule):
                if MODALITY_INFO[group[0]["target_domain"]].type == IMG:
                    mod_dict = self._generate_img_target(mod_dict, group, gen, top_k, top_p,
                                                         counts=counts)
                else:
                    mod_dict = self._generate_one_step(mod_dict, group[0], gen, top_k, top_p,
                                                       counts, text_tokenizer)
        return mod_dict

    def generate_iter(self, mod_dict, schedule: List[dict], seed: Optional[int] = None,
                      top_k: Optional[float] = None, top_p: Optional[float] = None,
                      text_tokenizer=None):
        """Step-by-step variant of `generate` (fourm_tpu sampler.py:766-779,
        reference generate.py:1098-1166): yields the mod dict after each
        step, as a new dict. The steps are generate's, in its order, drawing
        from one generator seeded as generate's, and an image target's steps
        run at the encoder budget generate gives them (its last step's), so
        the last yield equals generate's result."""
        top_k = self.top_k if top_k is None else top_k
        top_p = self.top_p if top_p is None else top_p
        gen, counts, mod_dict = self._start(mod_dict, seed)
        for group in self._group_schedule(schedule):
            budget = (self._group_budget(counts, mod_dict, group)
                      if MODALITY_INFO[group[0]["target_domain"]].type == IMG else OWN_BUDGET)
            for step_info in group:
                with torch.inference_mode():
                    mod_dict = self._generate_one_step(mod_dict, step_info, gen, top_k, top_p,
                                                       counts, text_tokenizer, budget)
                yield dict(mod_dict)

    def generate_multi_guided(self, uncond_dict, cond_dicts: Sequence[Dict], schedule: List[dict],
                              seed: Optional[int] = None, top_k: Optional[float] = None,
                              top_p: Optional[float] = None):
        """Weighted guidance by several conditions, over image targets
        (fourm_tpu sampler.py:229-277, :882-919; reference
        generate.py:1168-1227): each step runs the n conditioned dicts and
        the unconditioned one in one forward of (n + 1) B rows over the whole
        encoder stream and mixes their logits as lu + sum_i w_i (l_i - lu),
        w the step's list of cfg_scale weights; it accepts as `generate`
        does (ROAR's subset, or MaskGIT's most confident tokens) and updates
        the target in every dict that holds it. Returns uncond_dict, as
        tensors on the model's device."""
        top_k = self.top_k if top_k is None else top_k
        top_p = self.top_p if top_p is None else top_p
        dev = self.model.device
        gen = torch.Generator(device=dev).manual_seed(0 if seed is None else int(seed))
        uncond_dict = _on_device(uncond_dict, dev)
        cond_dicts = [_on_device(cd, dev) for cd in cond_dicts]
        n = len(cond_dicts)
        for step_info in schedule:
            target_mod = step_info["target_domain"]
            if MODALITY_INFO[target_mod].type != IMG:
                raise ValueError("multi-guided generation currently supports img targets")
            scheme = step_info["scheme"].lower()
            num_select = int(step_info["num_tokens"])
            weights = [float(w) for w in step_info["cfg_scale"]]
            with torch.inference_mode():
                d_t = uncond_dict[target_mod]
                B = d_t["tensor"].shape[0]
                still = ~d_t["target_mask"]
                sa_valid = _decoder_keys(still, scheme, num_select, gen)
                logits = self.model.forward_generation_img(
                    _tree_concat(cond_dicts + [uncond_dict]), target_mod,
                    torch.cat([sa_valid] * (n + 1), 0)).float()
                lu = logits[n * B:]
                guided = lu
                for i in range(n):
                    guided = guided + weights[i] * (logits[i * B:(i + 1) * B] - lu)
                tensor, input_mask, target_mask = _accept(
                    d_t, scheme, still, sa_valid, guided, float(step_info["temperature"]),
                    num_select, top_k, top_p, gen)
            for dd in [uncond_dict] + cond_dicts:
                if target_mod in dd:
                    dd[target_mod] = {**dd[target_mod], "tensor": tensor,
                                      "input_mask": input_mask, "target_mask": target_mask}
        return uncond_dict

    def generate_sam_dense(self, mod_dict, schedule: List[dict], text_tokenizer=None,
                           batch_size: int = 16, key: str = "sam_instance",
                           seed: Optional[int] = None):
        """Dense SAM instances (fourm_tpu sampler.py:848-880, reference
        generate.py:1229-1273): the schedule's `key` steps over batch_size
        replicas of mod_dict (each draws its own query points through the AR
        sampler), then every replica's merged sequence, in order, as one
        instance list of one row. Returns a copy of mod_dict whose `key` is
        that list, as tensors on the model's device."""
        tok = self._tokenizer(text_tokenizer, key)
        sentinel_ids = set(get_sentinel_to_id_mapping(tok).values())
        batch = expand_to_batch({m: {k: np.array(_np(v)) for k, v in d.items()}
                                 for m, d in mod_dict.items()}, batch_size)
        out = self.generate(batch, [s for s in schedule if s["target_domain"] == key],
                            seed=seed, text_tokenizer=tok)
        tensor, input_mask, target_mask = (_np(out[key][k])
                                           for k in ("tensor", "input_mask", "target_mask"))
        merged = []
        for i in range(batch_size):
            merged.extend(merge_span_masking(tensor[i][~input_mask[i]].tolist(),
                                             tensor[i][~target_mask[i]].tolist(), sentinel_ids))
        merged = torch.tensor(merged, dtype=torch.int32, device=self.model.device)[None]
        result = {m: dict(d) for m, d in mod_dict.items()}
        result[key] = {"tensor": merged, "input_mask": torch.zeros_like(merged, dtype=torch.bool),
                       "target_mask": torch.ones_like(merged, dtype=torch.bool),
                       "decoder_attention_mask": torch.zeros_like(merged)}
        return result
