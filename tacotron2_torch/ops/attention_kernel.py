"""Attention tail: energies -> masked softmax -> context, one decode step.

Replaces the Pallas kernel ``tacotron2_tpu/ops/attention_kernel.py::
attention_tail``.  The forward is the kernel; the backward, which the JAX
package writes in plain ``jnp`` (``_attention_tail_bwd``), is plain PyTorch
here (:class:`_AttentionTail`):

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
    f = torch.promote_types(qsum.dtype, torch.float32)
    th = torch.tanh(qsum.to(f))
    e = (th @ v_w.to(f) + v_b.to(f)) * energy_scale.to(f)
    e = e.masked_fill(mask, -1e9)
    attn = torch.softmax(e, dim=1)
    mem = memory.to(qsum.dtype).to(f)
    ctx = torch.einsum("bt,btd->bd", attn, mem)
    return attn, ctx


def _forward(qsum: torch.Tensor, v_w: torch.Tensor, v_b: torch.Tensor,
             energy_scale: torch.Tensor, mask: torch.Tensor,
             memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
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


class _AttentionTail(torch.autograd.Function):
    """The tail with its analytic backward: the softmax/tanh chain in
    closed form, fp32 throughout, ``d_e`` zeroed under the mask.  Each
    gradient comes back in its input's dtype, so ``d_memory`` stays fp32
    when ``memory`` came in fp32 (as it does even under bf16 compute: it
    is the encoder's whole gradient signal)."""

    @staticmethod
    def forward(ctx, qsum, v_w, v_b, energy_scale, mask, memory):
        attn, context = _forward(qsum, v_w, v_b, energy_scale, mask, memory)
        ctx.save_for_backward(qsum, v_w, v_b, energy_scale, mask, memory,
                              attn)
        return attn, context

    @staticmethod
    def backward(ctx, d_attn_out, d_ctx):
        qsum, v_w, v_b, energy_scale, mask, memory, attn = ctx.saved_tensors
        d_attn_out, d_ctx = d_attn_out.float(), d_ctx.float()
        th = torch.tanh(qsum.float())                        # (B, T, A)
        pre = th @ v_w.float() + v_b.float()
        d_attn = d_attn_out + torch.einsum("bd,btd->bt", d_ctx,
                                           memory.float())
        d_memory = torch.einsum("bt,bd->btd", attn, d_ctx)
        d_e = attn * (d_attn - (d_attn * attn).sum(dim=1, keepdim=True))
        d_e = d_e.masked_fill(mask, 0.0)                     # -1e9 branch
        d_scale = (d_e * pre).sum()
        d_pre = d_e * energy_scale.float()
        d_v_b = d_pre.sum()
        d_v_w = torch.einsum("bta,bt->a", th, d_pre)
        d_qsum = d_pre[..., None] * v_w.float() * (1.0 - th * th)
        return (d_qsum.to(qsum.dtype), d_v_w.to(v_w.dtype),
                d_v_b.to(v_b.dtype).reshape(v_b.shape),
                d_scale.to(energy_scale.dtype).reshape(energy_scale.shape),
                None, d_memory.to(memory.dtype))


def attention_tail(qsum: torch.Tensor, v_w: torch.Tensor, v_b: torch.Tensor,
                   energy_scale: torch.Tensor, mask: torch.Tensor,
                   memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same signature and returns as :func:`attention_tail_reference`,
    differentiable in ``qsum``, ``v_w``, ``v_b``, ``energy_scale`` and
    ``memory``.

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel (or raise).  ``attention_tail.launches`` counts launches.
    """
    return _AttentionTail.apply(qsum, v_w, v_b, energy_scale, mask, memory)


attention_tail.launches = 0
