"""Reverse chain of the split-BPTT decoder backward as one launch.

Replaces the Pallas kernel ``tacotron2_tpu/ops/decoder_bwd_kernel.py::
decoder_bwd_chain_mega``.  The CUDA C++ kernel (``csrc/decoder_train_bwd.cu``)
is a persistent cooperative kernel whose time loop runs on the card from
the last step to the first; its source note describes the phases, the
transposed weight copies it reads and its bound.  The plain version,
:func:`decoder_bwd_chain_reference`, is a Python loop over the steps that
does the kernel's arithmetic with the same roundings.

Inputs are the series the forward (``ops/decoder_train_kernel.py``) stored
and the output cotangents ``d_out_s (T, B, M+1)``, ``d_attn_out (T, B,
T_enc)``.  Per step: gate activations re-derived in fp32 from the stored
PRE-activations, ``tanh(c_t)`` from the stored cell states (the previous
cell state is row t-1 of the same series, zero at t = 0); head backward;
decoder-LSTM gate gradients, rounded to the compute dtype BEFORE the two
transposed products, and that rounded value is what is emitted;
``d_attn`` (with ``d_ctx`` rounded to the compute dtype against memory);
softmax backward on the stored row; ``d_qsum`` through a tanh re-derived
from the stored rounded qsum; location and query backward;
attention-LSTM backward.  Both return, in this order,

    g_att_s, g_dec_s (T, B, 4H) cdt   gate gradients
    d_ctx_s (T, B, E) fp32            d_pre_s (T, B, P) fp32
    d_qsum_s (T, B, T_enc*A) cdt      d_pq_s (T, B, A) fp32
    dv (B, A) fp32                    sum over steps of th * d_e * scale
    dpm (B, T_enc*A) fp32             sum over steps of the UNROUNDED d_qsum
    scal (2,) fp32                    [sum d_e * (e_raw + v_b), sum d_e]

from which the weight gradients are time-batched products
(``ops/decoder_bptt.py``).  The kernel runs at ``kernel_widths``, as the
forward does (``ops/decoder_train_kernel.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from . import _build
from .decoder_megakernel import kernel_widths, pad_operands
from .decoder_train_kernel import (acc_dtype, check_keep_mask,
                                   check_pair_inputs, pad_series,
                                   unpad_series)


def _gate_grads(d_h_drop, keep, mk, pre, c_t, c_prev, d_c, cdt):
    """One LSTM's gate gradients (rounded to cdt) and new cell carry from
    the gradient of its hidden state after dropout."""
    d_h = (d_h_drop / keep) * mk if keep < 1.0 else d_h_drop
    i, f, g, o = pre.chunk(4, dim=-1)
    i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                  torch.sigmoid(o))
    tc = torch.tanh(c_t)
    d_o = d_h * tc
    d_cv = d_c + d_h * o * (1.0 - tc * tc)
    grads = torch.cat([d_cv * g * i * (1.0 - i),
                       d_cv * c_prev * f * (1.0 - f),
                       d_cv * i * (1.0 - g * g),
                       d_o * o * (1.0 - o)], dim=-1).to(cdt)
    return grads, d_cv * f


def decoder_bwd_chain_reference(
        cfg: ModelConfig, ops: Dict[str, torch.Tensor], memory: torch.Tensor,
        mka_s: Optional[torch.Tensor], mkd_s: Optional[torch.Tensor],
        aa_s: torch.Tensor, ad_s: torch.Tensor, ca_s: torch.Tensor,
        cd_s: torch.Tensor, attns: torch.Tensor, qsum_s: torch.Tensor,
        d_out_s: torch.Tensor, d_attn_out: torch.Tensor
        ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: a loop over the steps, last to first."""
    cdt = ops["wi_a"].dtype
    f = acc_dtype(cdt)
    r = lambda x: x.to(cdt).to(f)
    t_dec, b, _ = aa_s.shape
    t_enc, e = memory.shape[1], memory.shape[2]
    h, p, a = cfg.decoder_rnn_dim, cfg.prenet_dim, cfg.attention_dim
    k = cfg.location_kernel_size
    lpad = (k - 1) // 2
    keep_a = 1.0 - cfg.p_attention_dropout
    keep_d = 1.0 - cfg.p_decoder_dropout
    # (out, in) weights as they lie: g (B, out) @ W contracts the out dim
    w = {n: ops[n].to(f) for n in ("wi_a", "wh_a", "wi_d", "wh_d", "wq",
                                   "w_heads", "wloc")}
    v, v_b, scale = ops["v"], ops["scal"][0], ops["scal"][1]
    mem_c = r(memory)
    dev = memory.device
    z = lambda *shape: torch.zeros(*shape, dtype=f, device=dev)
    d_ha, d_ca, d_hd, d_cd = z(b, h), z(b, h), z(b, h), z(b, h)
    d_ctxn, d_prev, d_cum = z(b, e), z(b, t_enc), z(b, t_enc)
    dv, dpm, scal = z(b, a), z(b, t_enc * a), z(2)
    zero_c = z(b, h)
    outs = [[None] * t_dec for _ in range(6)]
    for t in range(t_dec - 1, -1, -1):
        # head and decoder LSTM
        d_proj = r(d_out_s[t]) @ w["w_heads"]                 # (B, H+E)
        d_ctx = d_proj[:, h:] + d_ctxn
        g_dec, d_cd = _gate_grads(
            d_proj[:, :h] + d_hd, keep_d,
            None if keep_d >= 1.0 else mkd_s[t].to(f), ad_s[t].to(f),
            cd_s[t], cd_s[t - 1] if t > 0 else zero_c, d_cd, cdt)
        d_xd = g_dec.to(f) @ w["wi_d"]
        d_hd = g_dec.to(f) @ w["wh_d"]
        d_ctx = d_ctx + d_xd[:, h:]
        # attention: every use of ctx_t is accounted for, on to attn_t
        attn = attns[t]
        d_attn = (d_attn_out[t] + d_prev + d_cum
                  + torch.einsum("bd,bsd->bs", r(d_ctx), mem_c))
        s = (attn * d_attn).sum(dim=-1, keepdim=True)
        d_e = attn * (d_attn - s)
        d_eraw = d_e * scale
        th = torch.tanh(qsum_s[t].reshape(b, t_enc, a).to(f))
        d_qsum = d_eraw[:, :, None] * v * (1.0 - th * th)     # (B, T, A)
        dpm = dpm + d_qsum.reshape(b, t_enc * a)
        d_pq = d_qsum.sum(dim=1)
        dv = dv + (th * d_eraw[:, :, None]).sum(dim=1)
        e_raw = (th * v).sum(dim=-1)
        scal = scal + torch.stack([(d_e * (e_raw + v_b)).sum(), d_e.sum()])
        d_ha_att = r(d_pq) @ w["wq"]
        d_qsum_c = d_qsum.to(cdt)
        # location backward, a K-tap correlation with the composed matrix:
        # d_prev[b, s'] = sum_{k, j} d_qsum_c[b, s'+lpad-k, j] * wloc[k, j]
        taps = F.pad(d_qsum_c.to(f) @ w["wloc"].t(),
                     (0, 0, k - 1 - lpad, lpad))              # (B, T+K-1, 2K)
        win = taps.unfold(1, k, 1).flip(-1)                   # (B, T, 2K, K)
        d_cum = d_cum + win[:, :, k:].diagonal(dim1=2, dim2=3).sum(-1)
        d_prev = win[:, :, :k].diagonal(dim1=2, dim2=3).sum(-1)
        # attention LSTM
        g_att, d_ca = _gate_grads(
            d_xd[:, :h] + d_ha_att + d_ha, keep_a,
            None if keep_a >= 1.0 else mka_s[t].to(f), aa_s[t].to(f),
            ca_s[t], ca_s[t - 1] if t > 0 else zero_c, d_ca, cdt)
        d_xa = g_att.to(f) @ w["wi_a"]
        d_ha = g_att.to(f) @ w["wh_a"]
        d_ctxn = d_xa[:, p:]
        for lst, x in zip(outs, (g_att, g_dec, d_ctx, d_xa[:, :p],
                                 d_qsum_c.reshape(b, t_enc * a), d_pq)):
            lst[t] = x
    return tuple(torch.stack(lst) for lst in outs) + (dv, dpm, scal)


class _Args(ctypes.Structure):
    """Mirror of ``struct TrainBwdArgs`` in csrc/decoder_train_bwd.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "w_b", "w_e", "wq_t", "w_heads_t", "wloc",
        "v", "scal", "mem", "mka", "mkd", "aa_s", "ad_s", "ca_s", "cd_s",
        "attn_s", "qsum_s", "d_out", "d_attn_out",
        "g_att_s", "g_dec_s", "d_ctx_s", "d_pre_s", "d_qsum_s", "d_pq_s",
        "dv", "dpm", "scal_out",
        "d_ha", "d_ca", "d_hd", "d_cd", "d_ctxn", "d_prev", "d_cum",
        "d_ha_drop", "d_ctx_head", "d_ctx", "d_attn", "d_pq_w",
        "part_pq", "part_dv", "part_sc")]
        + [(n, ctypes.c_int) for n in (
            "B", "T", "H", "P", "E", "A", "M", "MP", "K", "S")]
        + [("keep_a", ctypes.c_float), ("keep_d", ctypes.c_float),
           ("grid_blocks", ctypes.c_int)])


# constants of csrc/decoder_common.cuh
_POSITIONS_PER_BLOCK = 8      # kWarps
_M_TILE = 16                  # kMTile: batch rows of one product pass
_TILE_ROWS = 8                # kTileRows: weight rows of one pass
_CHUNK_BYTES = 512            # kChunkBytes: bytes of a row per K-chunk
_PRODUCT_SMEM_BYTES = (6 * (_M_TILE + _TILE_ROWS) * _CHUNK_BYTES
                       + _M_TILE * _TILE_ROWS * 4)
# two blocks an SM: 228 KB of shared memory less 1 KB reserved per block
_SMEM_PER_BLOCK = (228 - 2) * 1024 // 2
# the longest location conv: phase C3 stages at least 8 columns of its
# kWarps + K - 1 rows and (2K, A) matrix, 4 bytes a value (kMaxLocTaps)
MAX_LOCATION_TAPS = (_SMEM_PER_BLOCK // (4 * 8) - _POSITIONS_PER_BLOCK
                     + 1) // 3


def c2_cols(a: int) -> int:
    """Columns of A that phase C2 sums at once (``c2_cols`` in the
    kernel): all of A where its two (8, A) fp32 partials fit a block, else
    the most in whole warps' worth of 32."""
    fit = ((_SMEM_PER_BLOCK // 4 - 2 * _POSITIONS_PER_BLOCK)
           // (2 * _POSITIONS_PER_BLOCK))
    return a if a <= fit else fit // 32 * 32


def c3_cols(a: int, taps: int) -> int:
    """Columns of A that phase C3 stages at once (``c3_cols`` in the
    kernel): all of A where the 8 + K - 1 rows and the (2K, A) matrix fit a
    block as fp32, else chunks of a multiple of 8 evened out over A; 0
    past :data:`MAX_LOCATION_TAPS`."""
    fit = _SMEM_PER_BLOCK // (4 * (_POSITIONS_PER_BLOCK + 3 * taps - 1))
    fit = fit // 8 * 8
    if fit >= a:
        return a
    if fit < 8:
        return 0
    per_chunk = -(-a // -(-a // fit))
    return -(-per_chunk // 8) * 8


class ChainPlan(NamedTuple):
    """How the kernel cuts one launch, as ``csrc/decoder_train_bwd.cu``
    computes it on the card."""
    m_tiles: int           # passes of each product over the batch (16 rows)
    k_chunks: int          # K-chunks of one row of B's and E's operand (4H)
    head_cols: int         # M + 1 padded to 8: phase A's K
    position_chunks: int   # blocks of 8 encoder positions in C2 and C3
    smem_bytes: int        # dynamic shared memory of a block
    location_cols: int     # columns of A that C3 stages at once
    location_chunks: int   # C3's chunks over A (1 at the default widths)


def chain_plan(dims: Dict[str, int], b: int, t_enc: int, taps: int,
               cdt: torch.dtype) -> ChainPlan:
    """The plan of one launch at the kernel's widths ``dims`` (H, P, E,
    A, M, multiples of 8: ``kernel_widths``), batch ``b``, ``t_enc``
    encoder steps and a location conv of ``taps`` taps.  Phase A's
    operand, the output cotangent, is zero-padded from M + 1 to 8 columns.
    Any A: phases C2 and C3 go over it in column chunks where it does not
    fit a block at once.  Raises on an empty batch or encoder, a weight
    dtype other than fp32 or bf16, and taps past
    :data:`MAX_LOCATION_TAPS` (1203)."""
    if b < 1 or t_enc < 1:
        raise ValueError(f"decoder_bwd_chain_mega: batch {b}, T_enc {t_enc}")
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decoder_bwd_chain_mega: weight dtype {cdt}")
    if not 1 <= taps <= MAX_LOCATION_TAPS:
        raise ValueError(
            f"decoder_bwd_chain_mega: a location conv of {taps} taps; phase "
            f"C3 takes up to {MAX_LOCATION_TAPS}, where 8 columns of its "
            f"staged rows and matrix fill a block's {_SMEM_PER_BLOCK} bytes")
    h, a, m = dims["H"], dims["A"], dims["M"]
    cols = c3_cols(a, taps)
    # phase C2's partials, C3's staged rows and location matrix (as fp32),
    # the products' ring: one region, used in turn
    smem = max(4 * (2 * _POSITIONS_PER_BLOCK * c2_cols(a)
                    + 2 * _POSITIONS_PER_BLOCK),
               4 * (_POSITIONS_PER_BLOCK + 3 * taps - 1) * cols,
               _PRODUCT_SMEM_BYTES)
    row_bytes = 4 * h * (2 if cdt == torch.bfloat16 else 4)
    return ChainPlan(m_tiles=-(-b // _M_TILE),
                     k_chunks=-(-row_bytes // _CHUNK_BYTES),
                     head_cols=-(-(m + 1) // 8) * 8,
                     position_chunks=-(-t_enc // _POSITIONS_PER_BLOCK),
                     smem_bytes=smem, location_cols=cols,
                     location_chunks=-(-a // cols))


def product_weights(ops: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two products' weights as the kernel reads them, one contiguous
    row per input: ``[wi_d | wh_d]`` and ``[wi_a | wh_a]`` transposed, so
    that ``g @ w.t()`` is the pair of products ``g @ wi, g @ wh``."""
    return tuple(torch.cat([ops[i], ops[h]], dim=1).t().contiguous()
                 for i, h in (("wi_d", "wh_d"), ("wi_a", "wh_a")))


def _lib() -> ctypes.CDLL:
    lib = _build.load("decoder_train_bwd")
    lib.t2_decoder_train_bwd.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
    lib.t2_decoder_train_bwd.restype = ctypes.c_int
    lib.t2_decoder_train_bwd_args_size.argtypes = []
    lib.t2_decoder_train_bwd_args_size.restype = ctypes.c_int
    lib.t2_decoder_train_bwd_smem_bytes.argtypes = [ctypes.POINTER(_Args)]
    lib.t2_decoder_train_bwd_smem_bytes.restype = ctypes.c_int
    lib.t2_decoder_train_bwd_c3_cols.argtypes = [ctypes.c_int] * 2
    lib.t2_decoder_train_bwd_c3_cols.restype = ctypes.c_int
    if lib.t2_decoder_train_bwd_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("TrainBwdArgs layout differs between csrc/"
                           "decoder_train_bwd.cu and "
                           "ops/decoder_bwd_kernel.py")
    return lib


def decoder_bwd_chain_mega(
        cfg: ModelConfig, ops: Dict[str, torch.Tensor], memory: torch.Tensor,
        mka_s: Optional[torch.Tensor], mkd_s: Optional[torch.Tensor],
        aa_s: torch.Tensor, ad_s: torch.Tensor, ca_s: torch.Tensor,
        cd_s: torch.Tensor, attns: torch.Tensor, qsum_s: torch.Tensor,
        d_out_s: torch.Tensor, d_attn_out: torch.Tensor
        ) -> Tuple[torch.Tensor, ...]:
    """Same signature and returns as :func:`decoder_bwd_chain_reference`.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise), at ``kernel_widths``.  ``decoder_bwd_chain_mega.launches``
    counts launches.
    """
    name = "decoder_bwd_chain_mega"
    args_in = (cfg, ops, memory, mka_s, mkd_s, aa_s, ad_s, ca_s, cd_s, attns,
               qsum_s, d_out_s, d_attn_out)
    if memory.device.type == "cpu":
        return decoder_bwd_chain_reference(*args_in)
    if memory.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {memory.device}")
    t_dec, b, _ = aa_s.shape
    t_enc = memory.shape[1]
    dims = check_pair_inputs(name, cfg, ops, memory, t_dec)
    H, M, A = dims["H"], dims["M"], dims["A"]
    dev, cdt = memory.device, ops["wi_a"].dtype
    want = dict(aa_s=((t_dec, b, 4 * H), cdt), ad_s=((t_dec, b, 4 * H), cdt),
                ca_s=((t_dec, b, H), torch.float32),
                cd_s=((t_dec, b, H), torch.float32),
                attns=((t_dec, b, t_enc), torch.float32),
                qsum_s=((t_dec, b, t_enc * A), cdt),
                d_out_s=((t_dec, b, M + 1), torch.float32),
                d_attn_out=((t_dec, b, t_enc), torch.float32))
    series = dict(aa_s=aa_s, ad_s=ad_s, ca_s=ca_s, cd_s=cd_s, attns=attns,
                  qsum_s=qsum_s, d_out_s=d_out_s, d_attn_out=d_attn_out)
    for n, x in series.items():
        if (tuple(x.shape), x.dtype) != want[n] or x.device != dev:
            raise ValueError(f"{name}: {n} is {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}, expected {want[n]} on {dev}")
    if memory.shape[0] != b:
        raise ValueError(f"{name}: memory batch {memory.shape[0]} != {b}")
    keep_a = 1.0 - cfg.p_attention_dropout
    keep_d = 1.0 - cfg.p_decoder_dropout
    kd = kernel_widths(cfg)
    pad = lambda x, kind: pad_series(x, kind, dims, kd).contiguous()
    ops = pad_operands(ops, dims, kd)
    H, M, A, E, P = (kd[n] for n in "HMAEP")
    plan = chain_plan(kd, b, t_enc, cfg.location_kernel_size, cdt)
    mp = plan.head_cols
    tr = lambda x: x.t().contiguous()
    e = lambda *shape, dtype=torch.float32: torch.empty(*shape, device=dev,
                                                        dtype=dtype)
    z = lambda *shape: torch.zeros(*shape, device=dev)
    nc = plan.position_chunks
    w_b, w_e = product_weights(ops)
    ins = dict(
        w_b=w_b, w_e=w_e, wq_t=tr(ops["wq"]),
        w_heads_t=F.pad(tr(ops["w_heads"]), (0, mp - M - 1)).contiguous(),
        wloc=ops["wloc"], v=ops["v"], scal=ops["scal"],
        mem=pad(memory.detach().to(cdt), "E"),
        aa_s=pad(aa_s, "4H"), ad_s=pad(ad_s, "4H"),
        ca_s=pad(ca_s, "H"), cd_s=pad(cd_s, "H"),
        attn_s=attns.contiguous(), qsum_s=pad(qsum_s, "TA"),
        d_out=F.pad(pad(d_out_s, "M+1"), (0, mp - M - 1)).to(
            cdt).contiguous(),
        d_attn_out=d_attn_out.contiguous())
    for key, mk, keep in (("mka", mka_s, keep_a), ("mkd", mkd_s, keep_d)):
        ins[key] = check_keep_mask(name, mk, keep, (t_dec, b, dims["H"]),
                                   ins["ca_s"])
        if keep < 1.0:
            ins[key] = pad(ins[key], "H")
    out = dict(g_att_s=e(t_dec, b, 4 * H, dtype=cdt),
               g_dec_s=e(t_dec, b, 4 * H, dtype=cdt),
               d_ctx_s=e(t_dec, b, E), d_pre_s=e(t_dec, b, P),
               d_qsum_s=e(t_dec, b, t_enc * A, dtype=cdt),
               d_pq_s=e(t_dec, b, A), dv=z(b, A), dpm=z(b, t_enc * A),
               scal_out=z(2))
    scratch = dict(
        d_ha=z(b, H), d_ca=z(b, H), d_hd=z(b, H), d_cd=z(b, H),
        d_ctxn=z(b, E), d_prev=z(b, t_enc), d_cum=z(b, t_enc),
        d_ha_drop=e(b, H),
        d_ctx_head=e(b, E), d_ctx=e(b, E), d_attn=e(b, t_enc),
        d_pq_w=e(b, A, dtype=cdt),
        part_pq=e(b, nc, A), part_dv=e(b, nc, A), part_sc=e(b, nc, 2))
    tensors = {**ins, **out, **scratch}
    args = _Args(**{k: v.data_ptr() for k, v in tensors.items()},
                 B=b, T=t_enc, MP=mp, K=cfg.location_kernel_size, S=t_dec,
                 keep_a=keep_a, keep_d=keep_d, **kd)
    err = _lib().t2_decoder_train_bwd(
        ctypes.byref(args), int(cdt == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    decoder_bwd_chain_mega.launches += 1
    decoder_bwd_chain_mega.last_grid_blocks = args.grid_blocks
    decoder_bwd_chain_mega.last_plan = plan
    kinds = dict(g_att_s="4H", g_dec_s="4H", d_ctx_s="E", d_pre_s="P",
                 d_qsum_s="TA", d_pq_s="A", dv="A", dpm="TA")
    return tuple(unpad_series(x, kinds[k], dims, kd) if k in kinds else x
                 for k, x in out.items())


decoder_bwd_chain_mega.launches = 0
decoder_bwd_chain_mega.last_grid_blocks = 0
decoder_bwd_chain_mega.last_plan = None
