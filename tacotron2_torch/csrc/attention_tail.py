"""Triton kernel of the attention tail (wrapper: ops/attention_kernel.py).

Replaces the forward of the Pallas kernel
``tacotron2_tpu/ops/attention_kernel.py::attention_tail``.  Bound on an
H100: bytes (qsum and memory read once, attn and ctx written once; a few
hundred KB per call at serving shapes), so at B <= 64, T_enc <= 256 the
launch costs more than the work.  One program per (batch item, 128-column
chunk of D) keeps the whole softmax in registers.

Imported only by the launching function: this module imports ``triton``,
which exists only where there is a CUDA card.
"""

import triton
import triton.language as tl


@triton.jit
def _attention_tail_kernel(q_ptr, vw_ptr, vb_ptr, scale_ptr, mask_ptr,
                           mem_ptr, attn_ptr, ctx_ptr, T, A, D,
                           BLOCK_T: tl.constexpr, BLOCK_A: tl.constexpr,
                           BLOCK_D: tl.constexpr,
                           ROUND_BF16: tl.constexpr):
    b = tl.program_id(0)
    dblk = tl.program_id(1)
    t = tl.arange(0, BLOCK_T)
    a = tl.arange(0, BLOCK_A)
    t_in = t < T
    a_in = a < A

    q = tl.load(q_ptr + b * T * A + t[:, None] * A + a[None, :],
                mask=t_in[:, None] & a_in[None, :], other=0.0
                ).to(tl.float32)
    # tanh(x) = 1 - 2 / (exp(2x) + 1): exact limits at +-inf, absolute
    # error ~1e-7 near 0.
    th = 1.0 - 2.0 / (tl.exp(2.0 * q) + 1.0)
    vw = tl.load(vw_ptr + a, mask=a_in, other=0.0).to(tl.float32)
    e = tl.sum(th * vw[None, :], axis=1)
    vb = tl.load(vb_ptr).to(tl.float32)
    scale = tl.load(scale_ptr).to(tl.float32)
    e = (e + vb) * scale
    pad = tl.load(mask_ptr + b * T + t, mask=t_in, other=1)
    e = tl.where(pad != 0, -1e9, e)
    e = tl.where(t_in, e, float("-inf"))
    w = tl.exp(e - tl.max(e, axis=0))
    attn = w / tl.sum(w, axis=0)
    tl.store(attn_ptr + b * T + t, attn, mask=t_in & (dblk == 0))

    d = dblk * BLOCK_D + tl.arange(0, BLOCK_D)
    d_in = d < D
    mem = tl.load(mem_ptr + b * T * D + t[:, None] * D + d[None, :],
                  mask=t_in[:, None] & d_in[None, :], other=0.0)
    if ROUND_BF16:
        mem = mem.to(tl.bfloat16)
    ctx = tl.sum(attn[:, None] * mem.to(tl.float32), axis=0)
    tl.store(ctx_ptr + b * D + d, ctx, mask=d_in)


def launch(qsum, v_w, v_b, energy_scale, mask_u8, memory, attn, ctx,
           round_bf16):
    """Launch on PyTorch's current stream.  All tensors contiguous and on
    one CUDA device; ``attn`` (B, T) and ``ctx`` (B, D) fp32 outputs;
    ``round_bf16`` rounds ``memory`` to bf16 in registers."""
    b, t, a = qsum.shape
    d = memory.shape[-1]
    block_t = triton.next_power_of_2(t)
    block_a = triton.next_power_of_2(a)
    block_d = 128
    tile = block_t * max(block_a, block_d)
    num_warps = 4 if tile <= 8192 else (8 if tile <= 32768 else 16)
    grid = (b, triton.cdiv(d, block_d))
    _attention_tail_kernel[grid](
        qsum, v_w, v_b, energy_scale, mask_u8, memory, attn, ctx, t, a, d,
        BLOCK_T=block_t, BLOCK_A=block_a, BLOCK_D=block_d,
        ROUND_BF16=round_bf16,
        num_warps=num_warps)
