"""fc2's weight as the decode step's residual_mlp kernel reads it
(fourm_torch/kernels/decode_step.py:_w2_for_tma), on the CPU.

A SwiGLU hidden width that is not a multiple of 8 (2730 and 5461 at 4M-L and
4M-XL) leaves W2's rows unaligned for TMA. The MLP modules keep a bf16 fc2
weight of such a width as the (C, HID) view of zero-padded storage
(ops/transformer.py:rows_padded), which the kernel reads in place; any other
ragged W2 is padded on the call. Whatever updates the weight in place -- an
inference-mode copy (an inference tensor keeps no version counter), a copy
under no_grad, a copy through `.data` (a new version counter) or
load_state_dict -- the kernel's W2 is the weight as it is now: no padded
copy outlives its call. The DecoderBlock.step comparison runs the plain
route, which the CPU takes, at HID = 2730 and C = 64.
"""

from __future__ import annotations

import pytest
import torch

from fourm_torch.kernels.decode_step import _w2_for_tma, residual_mlp_takes
from fourm_torch.ops.transformer import DecoderBlock, GatedMlp, rows_padded

C, HID = 64, 2730


def _rand(seed, *shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(torch.bfloat16)


def _ragged(style):
    """A ragged bf16 W2 and a function that updates it in place."""
    if style == "inference_copy":
        with torch.inference_mode():
            w = _rand(0, C, HID)

        def update(new):
            with torch.inference_mode():
                w.copy_(new)
    elif style == "module_view":
        with torch.inference_mode():
            w = GatedMlp(C, 4096).to(torch.bfloat16).fc2.weight

        def update(new):
            with torch.inference_mode():
                w.copy_(new)
    else:
        w = torch.nn.Parameter(_rand(0, C, HID))

        def update(new):
            with torch.no_grad():
                (w if style == "no_grad_copy" else w.data).copy_(new)
    return w, update


@pytest.mark.parametrize("style", ["inference_copy", "no_grad_copy", "data_copy",
                                   "module_view"])
def test_w2_for_tma_reads_the_weight_as_it_is_now(style):
    """A first call, an in-place update, a second call: the kernel's W2 holds
    the new values, TMA's row stride (a multiple of 8), and, for the
    modules' padded storage, the weight itself."""
    w, update = _ragged(style)
    first = _w2_for_tma(w)
    assert torch.equal(first[:, :HID], w)
    new = _rand(1, C, HID)
    update(new)
    second = _w2_for_tma(w)
    assert torch.equal(second[:, :HID], new)
    assert second.stride(0) % 8 == 0 and second.stride(1) == 1
    if style == "module_view":
        assert second.data_ptr() == w.data_ptr() and w.stride(0) == 2736


def test_padded_storage_survives_conversion_and_loading():
    """.to() and .bfloat16() re-pad a ragged bf16 fc2 weight; load_state_dict
    copies into the padded storage; the padding stays zero; residual_mlp's
    predicate takes the view; an fp32 weight (the training master) stays
    contiguous."""
    mlp = GatedMlp(C, 4096)
    assert mlp.fc2.weight.is_contiguous()
    mlp = mlp.to(torch.bfloat16)
    w = mlp.fc2.weight
    assert w.shape == (C, HID) and w.stride() == (2736, 1)
    full = torch.as_strided(w, (C, 2736), (2736, 1))
    assert not full[:, HID:].any()
    state = {k: v.clone().contiguous() * 2 for k, v in mlp.state_dict().items()}
    mlp.load_state_dict(state)
    assert mlp.fc2.weight.stride() == (2736, 1)
    assert torch.equal(mlp.fc2.weight, state["fc2.weight"])
    x = torch.zeros(2, C, dtype=torch.bfloat16)
    assert residual_mlp_takes(x, x, torch.zeros(C, C, dtype=torch.bfloat16), mlp.fc1.weight,
                              mlp.fc2.weight, mlp.fc3.weight)
    assert torch.equal(rows_padded(state["fc2.weight"]), state["fc2.weight"])
    assert mlp.float().fc2.weight.is_contiguous()


def _step_inputs(H=4, L=6, M=9, B=3):
    g = torch.Generator().manual_seed(3)
    Dh = C // H

    def rn(*shape):
        return (torch.randn(*shape, generator=g) * 0.5).to(torch.bfloat16)

    bias = torch.where(torch.rand(B, M, generator=g) < 0.3, torch.finfo(torch.float32).min, 0.0)
    return rn(B, 1, C), rn(B, H, L, Dh), rn(B, H, L, Dh), rn(B, H, M, Dh), rn(B, H, M, Dh), bias


def test_decoder_block_step_after_inference_mode_update():
    """A bf16 SwiGLU DecoderBlock at HID = 2730, built and stepped under
    torch.inference_mode(), then fc2 updated in place and stepped again,
    equals a block built with the new weights from the start; the update
    moves the output, and the weight stays the padded view the kernel reads
    in place."""
    kw = dict(dim=C, num_heads=4, mlp_ratio=64.0, qkv_bias=False, proj_bias=False,
              mlp_bias=False, act="silu", gated_mlp=True, norm_bias=False,
              dtype=torch.bfloat16)
    x, ck, cv, xk, xv, bias = _step_inputs()
    step = torch.tensor([2], dtype=torch.int32)
    with torch.inference_mode():
        torch.manual_seed(0)
        block = DecoderBlock(**kw).to(torch.bfloat16)
        before, _, _ = block.step(x, ck.clone(), cv.clone(), xk, xv, bias, step)
        new = _rand(5, C, HID)
        block.mlp.fc2.weight.copy_(new)
        after, _, _ = block.step(x, ck.clone(), cv.clone(), xk, xv, bias, step)
        assert _w2_for_tma(block.mlp.fc2.weight).data_ptr() == block.mlp.fc2.weight.data_ptr()
        torch.manual_seed(0)
        fresh = DecoderBlock(**kw).to(torch.bfloat16)
        fresh.mlp.fc2.weight.copy_(new)
        want, _, _ = fresh.step(x, ck.clone(), cv.clone(), xk, xv, bias, step)
    tol = 2.0 ** -6 * want.float().abs().max().item()  # two bf16 ulps of the output
    assert (after.float() - want.float()).abs().max().item() <= tol
    assert (after.float() - before.float()).abs().max().item() > 10 * tol
