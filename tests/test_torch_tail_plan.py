"""The attention tail's launch plan and split order, on the CPU.

The CUDA kernel (``tacotron2_torch/csrc/attention_tail.cu``) runs only on
a card; what it does on the host side and the order of its sums are held
here.  :func:`tail_plan` must cover every T_enc row once with a cluster of
at most eight blocks, none of them empty, within a block's shared memory,
and refuse what the kernel cannot take.  :func:`split_tail` replays the
kernel's order in plain PyTorch (each block's rows tile by tile with a
running max, sum and partial context, then the combination over the
cluster and its reduce-scatter over D / S columns); it is held against the port's ``attention_tail_reference``
(1e-6 absolute: fp32 sums in another order over at most 600 positions) and
against the JAX package's ``attention_tail``, whose Pallas kernel runs in
interpret mode here, at ``test_torch_attention.py``'s limits (1e-5 with
fp32 qsum, 1e-3 with bf16 qsum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.ops.attention_kernel import attention_tail as pallas_tail
from tacotron2_torch.ops.attention_kernel import (
    HEAD_BYTES, MAX_SPLIT, STAGE_BYTES, attention_tail,
    attention_tail_reference, tail_plan)

A, D = 16, 24
REF_TOL = 1e-6
JAX_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
SMEM_227_KB = 227 * 1024


def up16(n):
    return -(-n // 16) * 16


@pytest.mark.parametrize("mem_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 4, 16, 64])
@pytest.mark.parametrize("t", [1, 7, 32, 112, 128, 200, 600, 1000])
def test_tail_plan_covers_every_row_once(t, b, mem_dtype):
    plan = tail_plan(b, t, 128, 512, mem_dtype)
    assert plan.split in (1, 2, 4, 8) and plan.split <= MAX_SPLIT
    blocks = [range(r * plan.rows, min((r + 1) * plan.rows, t))
              for r in range(plan.split)]
    assert [row for blk in blocks for row in blk] == list(range(t))
    assert all(len(blk) > 0 for blk in blocks)
    row_bytes = 512 * mem_dtype.itemsize
    assert 1 <= plan.tile_rows <= plan.rows
    assert plan.tile_rows * row_bytes <= STAGE_BYTES
    assert plan.stages == (1 if plan.tile_rows == plan.rows else 2)
    cols = -(-512 // plan.split)
    assert plan.smem_bytes == (HEAD_BYTES
                               + plan.stages * plan.tile_rows * row_bytes
                               + up16(4 * 512) + up16(4 * plan.split * cols)
                               + 2 * up16(4 * plan.tile_rows))
    assert plan.smem_bytes <= SMEM_227_KB


@pytest.mark.parametrize("args,err,match", [
    ((0, 8, 128, 512, torch.float32), ValueError, "shapes"),
    ((1, 0, 128, 512, torch.float32), ValueError, "shapes"),
    ((1, 8, 128, 16392, torch.float32), ValueError, "ring stage"),
    ((1, 8, 128, 16384, torch.float32), ValueError, "shared memory"),
    ((1, 8, 128, 512, torch.float16), TypeError, "memory dtype"),
])
def test_tail_plan_refuses(args, err, match):
    with pytest.raises(err, match=match):
        tail_plan(*args)


@pytest.mark.parametrize("args", [
    (65536, 8, 128, 512, torch.float32),      # two launches
    (1, 8, 128, 20, torch.bfloat16),          # 40-byte rows, padded to 48
    (1, 8, 128, 17, torch.float32),           # 68-byte rows, padded to 80
    (1, 8, 126, 512, torch.float32),          # four loads a lane
    (2, 11, 13, 7, torch.float32),            # odd A and D
    (1, 40, 128, 8190, torch.float32),        # 32760-byte rows, 2 stages
])
def test_tail_plan_takes_any_a_and_d(args):
    """What the kernel once refused: B past 65535, memory rows that are no
    multiple of 16 bytes (staged padded to 16), A no multiple of 4."""
    b, t, a, d, mem_dtype = args
    plan = tail_plan(*args)
    row_bytes = up16(d * mem_dtype.itemsize)
    cols = -(-d // plan.split)
    assert plan.smem_bytes == (HEAD_BYTES
                               + plan.stages * plan.tile_rows * row_bytes
                               + up16(4 * d) + up16(4 * plan.split * cols)
                               + 2 * up16(4 * plan.tile_rows))


def split_tail(qsum, v_w, v_b, scale, mask, memory, plan):
    """The kernel's order of work in plain PyTorch, fp32.  Block r of an
    item takes rows [r * rows, (r + 1) * rows) tile by tile: the tile's
    energies, the running max m (alpha = exp(m_old - m) rescales the
    running sum s of exp(e - m) and the partial context, which takes the
    tile's rows).  Then M = max m_r, Z = sum_r s_r exp(m_r - M) in rank
    order, attn = exp(e - M) / Z, and block r sums columns [r, r + 1) *
    ceil(D / S) of sum_r exp(m_r - M) partial_r / Z in rank order."""
    b, t, _ = qsum.shape
    d = memory.shape[2]
    e = (torch.tanh(qsum.float()) @ v_w.float() + v_b.float()) * scale.float()
    e = e.masked_fill(mask, -1e9)
    mem = memory.to(qsum.dtype).float()
    stats, partials = [], []
    for r in range(plan.split):
        lo, hi = r * plan.rows, min((r + 1) * plan.rows, t)
        m = torch.full((b,), float("-inf"))
        s, part = torch.zeros(b), torch.zeros(b, d)
        for t0 in range(lo, hi, plan.tile_rows):
            t1 = min(t0 + plan.tile_rows, hi)
            m_new = torch.maximum(m, e[:, t0:t1].max(dim=1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(e[:, t0:t1] - m_new[:, None])
            s = s * alpha + p.sum(dim=1)
            part = part * alpha[:, None] + torch.einsum(
                "bt,btd->bd", p, mem[:, t0:t1])
            m = m_new
        stats.append((m, s))
        partials.append(part)
    big = torch.stack([m for m, _ in stats]).max(dim=0).values
    weights = [torch.exp(m - big) for m, _ in stats]
    z = torch.zeros(b)
    for (_, s), w in zip(stats, weights):
        z = z + s * w
    attn = torch.exp(e - big[:, None]) / z[:, None]
    cols = -(-d // plan.split)
    ctx = torch.empty(b, d)
    for r in range(plan.split):
        c0, c1 = r * cols, min(d, (r + 1) * cols)
        acc = torch.zeros(b, c1 - c0)
        for part, w in zip(partials, weights):
            acc = acc + w[:, None] * part[:, c0:c1]
        ctx[:, c0:c1] = acc / z[:, None]
    return attn, ctx


def seeded_inputs(lens, t, seed, dtype):
    rng = np.random.default_rng(seed)
    b = len(lens)
    qsum = rng.standard_normal((b, t, A)).astype(np.float32)
    v_w = (rng.standard_normal(A) * 0.5).astype(np.float32)
    v_b = np.float32(rng.standard_normal())
    scale = np.float32(1.2)
    mask = np.arange(t)[None, :] >= np.asarray(lens)[:, None]
    memory = rng.standard_normal((b, t, D)).astype(np.float32)
    port = (torch.from_numpy(qsum).to(dtype), torch.from_numpy(v_w),
            torch.tensor(v_b), torch.tensor(scale), torch.from_numpy(mask),
            torch.from_numpy(memory))
    jax_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_ins = (jnp.asarray(qsum, jax_dtype), jnp.asarray(v_w),
               jnp.asarray(v_b), jnp.asarray(scale), jnp.asarray(mask),
               jnp.asarray(memory))
    return port, jax_ins


# (case, lengths, T_enc, tile rows or None for the plan's own)
CASES = [
    ("ragged last chunk", [37, 25, 30], 37, None),       # S=8, rows 5, 2
    ("wholly padded chunk", [30, 37, 12], 37, None),     # ranks 6-7 pad
    ("all-padded row", [19, 0], 19, None),               # uniform row
    ("T_enc=1", [1, 1], 1, None),
    ("tiles of three rows", [128, 97, 64], 128, 3),      # S=8, 16 rows
    ("long input", [600, 421], 600, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,lens,t,tile_rows", CASES,
                         ids=[c[0] for c in CASES])
def test_split_order_matches_reference(case, lens, t, tile_rows, dtype):
    ins, jax_ins = seeded_inputs(lens, t, seed=len(case) + t, dtype=dtype)
    plan = tail_plan(len(lens), t, A, D, torch.float32)
    if tile_rows is not None:
        plan = plan._replace(tile_rows=tile_rows, stages=2)
    attn, ctx = split_tail(*ins, plan)
    ref_attn, ref_ctx = attention_tail_reference(*ins)
    assert float((attn - ref_attn).abs().max()) <= REF_TOL
    assert float((ctx - ref_ctx).abs().max()) <= REF_TOL
    j_attn, j_ctx = pallas_tail(*jax_ins)
    np.testing.assert_allclose(np.asarray(j_attn), attn.numpy(),
                               atol=JAX_TOL[dtype], rtol=0)
    np.testing.assert_allclose(np.asarray(j_ctx), ctx.numpy(),
                               atol=JAX_TOL[dtype], rtol=0)
    for i, n in enumerate(lens):
        if n == 0:      # every position padded: uniform, as the reference
            torch.testing.assert_close(attn[i], torch.full((t,), 1.0 / t),
                                       atol=REF_TOL, rtol=0)
        else:
            assert torch.all(attn[i, n:] == 0.0)


@pytest.mark.parametrize("wants_grad", [False, True])
def test_wrapper_builds_a_graph_only_for_a_gradient(wants_grad):
    """Without a gradient to take the wrapper leaves the autograd function
    out; the values are the same either way."""
    ins, _ = seeded_inputs([9, 6], 9, seed=4, dtype=torch.float32)
    qsum = ins[0].clone().requires_grad_(wants_grad)
    attn, ctx = attention_tail(qsum, *ins[1:])
    assert (attn.grad_fn is not None) == wants_grad
    ref = attention_tail_reference(*ins)
    assert torch.equal(attn.detach(), ref[0])
    assert torch.equal(ctx.detach(), ref[1])
