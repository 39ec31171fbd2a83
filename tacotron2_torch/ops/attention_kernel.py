"""Attention tail: energies -> masked softmax -> context, one decode step.

Replaces the Pallas kernel ``tacotron2_tpu/ops/attention_kernel.py::
attention_tail`` (forward; its backward comes with the training slice):

    e    = energy_scale * (tanh(qsum) . v_w + v_b)      # (B, T_enc)
    e    = where(mask, -1e9, e)
    attn = softmax(e)                                   # over T_enc
    ctx  = attn @ memory                                # (B, D)

Dtype policy (the Pallas kernel's): ``qsum`` arrives in the compute dtype
and is upcast before an fp32 tanh; energies and softmax are fp32;
``memory`` is read in the compute dtype of ``qsum`` and the context is
summed in fp32.

The kernel (``csrc/attention_tail.py``, Triton) runs one program per
(batch item, 128-column chunk of D).  Each program loads the item's whole
(T_enc, A) ``qsum`` tile and T_enc mask, computes the softmax in registers
and reduces its (T_enc, 128) slice of ``memory``; ``attn`` and ``ctx`` are
written once.  ``memory`` is read in its own dtype and rounded to the
compute dtype in registers, so no cast copy is made per step.

Bound on an H100 SXM: bytes.  Per call it must read qsum (B*T*A in the
compute dtype), memory (B*T*D), the mask and v, and write attn and ctx;
at B=1, T_enc=128 that is ~0.3 MB, 0.1 us at 3.35 TB/s, so a launch
(a few us) costs more than the work.  ``chip_smoke.py`` prints the
measured time beside this bound.
"""

from __future__ import annotations

from typing import Tuple

import torch


def attention_tail_reference(qsum: torch.Tensor, v_w: torch.Tensor,
                             v_b: torch.Tensor, energy_scale: torch.Tensor,
                             mask: torch.Tensor, memory: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version with the kernel's dtype policy.

    qsum (B, T, A) compute dtype; v_w (A,); v_b, energy_scale 0-d;
    mask (B, T) bool, True = pad; memory (B, T, D).
    Returns (attn (B, T) fp32, ctx (B, D) fp32).
    """
    th = torch.tanh(qsum.float())
    e = (th @ v_w.float() + v_b.float()) * energy_scale.float()
    e = e.masked_fill(mask, -1e9)
    attn = torch.softmax(e, dim=1)
    mem = memory.to(qsum.dtype).float()
    ctx = torch.einsum("bt,btd->bd", attn, mem)
    return attn, ctx


def attention_tail(qsum: torch.Tensor, v_w: torch.Tensor, v_b: torch.Tensor,
                   energy_scale: torch.Tensor, mask: torch.Tensor,
                   memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same signature and returns as :func:`attention_tail_reference`.

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel (or raise).  ``attention_tail.launches`` counts launches.
    """
    if qsum.device.type == "cpu":
        return attention_tail_reference(qsum, v_w, v_b, energy_scale, mask,
                                        memory)
    if qsum.device.type != "cuda":
        raise ValueError(f"attention_tail: unsupported device {qsum.device}")
    b, t, a = qsum.shape
    d = memory.shape[-1]
    if (qsum.dtype not in (torch.float32, torch.bfloat16)
            or memory.dtype not in (torch.float32, torch.bfloat16)
            or mask.dtype != torch.bool):
        raise TypeError(f"attention_tail: dtypes qsum {qsum.dtype}, memory "
                        f"{memory.dtype}, mask {mask.dtype}")
    if (memory.shape[:2] != (b, t) or mask.shape != (b, t)
            or v_w.shape != (a,)):
        raise ValueError("attention_tail: shape mismatch "
                         f"{tuple(qsum.shape)} {tuple(memory.shape)} "
                         f"{tuple(mask.shape)} {tuple(v_w.shape)}")
    for x in (v_w, v_b, energy_scale, mask, memory):
        if x.device != qsum.device:
            raise ValueError("attention_tail: tensors on different devices")
    from ..csrc.attention_tail import launch
    attn = torch.empty(b, t, device=qsum.device, dtype=torch.float32)
    ctx = torch.empty(b, d, device=qsum.device, dtype=torch.float32)
    launch(qsum.contiguous(), v_w.contiguous(), v_b.reshape(1),
           energy_scale.reshape(1), mask.contiguous().view(torch.uint8),
           memory.contiguous(), attn, ctx,
           round_bf16=(qsum.dtype == torch.bfloat16
                       and memory.dtype != torch.bfloat16))
    attention_tail.launches += 1
    return attn, ctx


attention_tail.launches = 0
