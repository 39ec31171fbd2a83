"""Teacher-forced decoder forward for training as one launch.

Replaces the Pallas kernel ``tacotron2_tpu/ops/decoder_train_kernel.py::
decoder_fwd_train_mega``.  The CUDA C++ kernel (``csrc/decoder_train_fwd.cu``)
is a persistent cooperative kernel whose time loop runs on the card; its
source note describes the phases and its bound (the decoder weights read
once per step plus the stored series, over the card's memory rate).  It
reads its weights in the layout :func:`train_weights` makes from
:func:`kernel_operands` on every call (the weights change at every
optimizer step).  The plain version, :func:`decoder_fwd_train_reference`,
is a Python loop over the steps that does the kernel's arithmetic with the
same roundings.

Per step, from the prenetted frame: attention LSTM, dropout by a 0/1 mask
(``(x / keep) * m``, skipped when ``keep == 1``), location-sensitive
attention through the composed ``(2K, A)`` conv+dense matrix (composed in
fp32, rounded to the compute dtype once), softmax, context, decoder LSTM,
dropout, fused projection + gate head.  Both return, in this order,

    frames (T, B, M+1) fp32     attn (T, B, T_enc) fp32
    ha_s, hd_s (T, B, H) cdt    hidden states AFTER dropout (what is carried)
    ca_s, cd_s (T, B, H) fp32   cell states
    qsum_s (T, B, T_enc*A) cdt  pre-tanh sums, the values the fp32 tanh took
    aa_s, ad_s (T, B, 4H) cdt   LSTM PRE-activations with both biases

as ``(frames, attn, ha_s, ca_s, hd_s, cd_s, qsum_s, aa_s, ad_s)``; cdt is
the weight dtype.  The stored series are what the reverse-chain kernel
(``ops/decoder_bwd_kernel.py``) consumes.

Both kernels of the pair run at ``ops/decoder_megakernel.py::
kernel_widths``, multiples of 8: where a config's widths are not, the
wrappers zero-pad the operands and inputs and cut the padding off what
comes back (:func:`pad_series`, :func:`unpad_series`); the padded units
stay 0 in the forward and take no gradient in the reverse chain, so each
sum only gains zero terms.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from . import _build
from .attention_kernel import attention_tail_reference
from .decoder_megakernel import (LSTM_TILE_ROWS, TILE_ROWS, gate_interleave,
                                 kernel_widths, location_layout, pad_gates,
                                 pad_operands, pad_to, ring_bytes,
                                 tile_major, unpad_gates, up16)

# Decoder parameters that the kernel pair reads, by their names under
# ``models.decoder.Decoder`` (the prenet and the memory layer act outside).
PARAM_NAMES = (
    "attention_lstm.weight_ih", "attention_lstm.weight_hh",
    "attention_lstm.bias_ih", "attention_lstm.bias_hh",
    "decoder_lstm.weight_ih", "decoder_lstm.weight_hh",
    "decoder_lstm.bias_ih", "decoder_lstm.bias_hh",
    "attention.query_layer.weight", "attention.location_conv.weight",
    "attention.location_dense.weight", "attention.v.weight",
    "attention.v.bias", "attention.energy_scale",
    "linear_projection.weight", "linear_projection.bias",
    "gate_layer.weight", "gate_layer.bias")


def acc_dtype(cdt: torch.dtype) -> torch.dtype:
    """The dtype sums are taken in: fp32, or fp64 for fp64 weights (which
    only the tests' independent float64 check uses)."""
    return torch.promote_types(cdt, torch.float32)


def kernel_operands(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The kernels' weight operands from the decoder parameters ``p``
    (keyed by :data:`PARAM_NAMES`): compute-dtype matrices in PyTorch
    layout, fp32 biases with ``bias_ih + bias_hh`` summed, the fused heads,
    and the location conv composed with the location dense layer in fp32
    and rounded once."""
    cdt = p["attention_lstm.weight_ih"].dtype
    f = acc_dtype(cdt)
    w = lambda x: x.detach().to(cdt).contiguous()
    a = lambda x: x.detach().to(f).contiguous()
    lw = p["attention.location_conv.weight"].detach().to(f)   # (F, 2, K)
    n_f, _, k = lw.shape
    wl = lw.permute(1, 2, 0).reshape(2 * k, n_f)              # (2K, F)
    wloc = wl @ p["attention.location_dense.weight"].detach().to(f).t()
    return dict(
        wi_a=w(p["attention_lstm.weight_ih"]),
        wh_a=w(p["attention_lstm.weight_hh"]),
        wi_d=w(p["decoder_lstm.weight_ih"]),
        wh_d=w(p["decoder_lstm.weight_hh"]),
        wq=w(p["attention.query_layer.weight"]), wloc=w(wloc),
        w_heads=w(torch.cat([p["linear_projection.weight"],
                             p["gate_layer.weight"]])),
        b_a=a(p["attention_lstm.bias_ih"].to(f)
              + p["attention_lstm.bias_hh"].to(f)),
        b_d=a(p["decoder_lstm.bias_ih"].to(f)
              + p["decoder_lstm.bias_hh"].to(f)),
        b_heads=a(torch.cat([p["linear_projection.bias"],
                             p["gate_layer.bias"]])),
        v=a(p["attention.v.weight"][0]),
        scal=a(torch.stack([p["attention.v.bias"][0].to(f),
                            p["attention.energy_scale"].to(f)])))


def operand_bytes(ops: Dict[str, torch.Tensor]) -> int:
    """Bytes of weights either kernel of the pair reads in every step."""
    return sum(x.numel() * x.element_size() for x in ops.values())


def _lstm(g: torch.Tensor, c: torch.Tensor):
    i, f, gg, o = g.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def location_windows(prev: torch.Tensor, cum: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """(B, T) previous and cumulative alignments -> (B, T, 2K) windows:
    ``[..., c*K + j] = pad(x_c)[b, t + j]`` with 'same' zero padding."""
    lpad = (k - 1) // 2
    pc = F.pad(torch.stack([prev, cum], dim=1), (lpad, k - 1 - lpad))
    win = pc.unfold(2, k, 1)                                  # (B, 2, T, K)
    return win.permute(0, 2, 1, 3).reshape(prev.shape[0], prev.shape[1],
                                           2 * k)


def decoder_fwd_train_reference(
        cfg: ModelConfig, ops: Dict[str, torch.Tensor],
        prenet_tbd: torch.Tensor, memory: torch.Tensor, pm: torch.Tensor,
        mask: torch.Tensor, mka_s: Optional[torch.Tensor],
        mkd_s: Optional[torch.Tensor],
        tail: Callable = attention_tail_reference) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: a loop over the steps with the kernel's
    arithmetic and roundings.  ``tail`` maps the rounded qsum to (attn,
    ctx); the step-loop route passes the CUDA ``attention_tail``.

    ``ops`` from :func:`kernel_operands`; ``prenet_tbd`` (T, B, P);
    ``memory`` (B, T_enc, E); ``pm`` (B, T_enc, A); ``mask`` (B, T_enc)
    bool, True = pad; ``mka_s`` / ``mkd_s`` (T, B, H) 0/1 keep-masks (unread
    when the dropout rate is 0, may be None).
    """
    cdt = ops["wi_a"].dtype
    f = acc_dtype(cdt)
    r = lambda x: x.to(cdt).to(f)            # round to the compute dtype
    t_dec, b, _ = prenet_tbd.shape
    t_enc = memory.shape[1]
    h, k = cfg.decoder_rnn_dim, cfg.location_kernel_size
    keep_a = 1.0 - cfg.p_attention_dropout
    keep_d = 1.0 - cfg.p_decoder_dropout
    wt = {n: ops[n].to(f).t() for n in ("wi_a", "wh_a", "wi_d", "wh_d", "wq",
                                        "w_heads")}
    wloc = ops["wloc"].to(f)
    pm = pm.to(f)
    z = lambda d: torch.zeros(b, d, dtype=f, device=memory.device)
    h_att, c_att, h_dec, c_dec = z(h), z(h), z(h), z(h)
    ctx, prev, cum = z(memory.shape[2]), z(t_enc), z(t_enc)
    outs = [[] for _ in range(9)]
    for t in range(t_dec):
        xa = torch.cat([r(prenet_tbd[t]), r(ctx)], dim=-1)
        ga = xa @ wt["wi_a"] + r(h_att) @ wt["wh_a"] + ops["b_a"]
        h_att, c_att = _lstm(ga, c_att)
        if keep_a < 1.0:
            h_att = (h_att / keep_a) * mka_s[t].to(f)
        pq = r(h_att) @ wt["wq"]
        loc = r(location_windows(prev, cum, k)) @ wloc
        qsum = (pq[:, None, :] + pm + loc).to(cdt)
        attn, ctx = tail(qsum, ops["v"], ops["scal"][0], ops["scal"][1],
                         mask, memory)
        prev, cum = attn, cum + attn
        xd = torch.cat([r(h_att), r(ctx)], dim=-1)
        gd = xd @ wt["wi_d"] + r(h_dec) @ wt["wh_d"] + ops["b_d"]
        h_dec, c_dec = _lstm(gd, c_dec)
        if keep_d < 1.0:
            h_dec = (h_dec / keep_d) * mkd_s[t].to(f)
        out = (torch.cat([r(h_dec), r(ctx)], dim=-1) @ wt["w_heads"]
               + ops["b_heads"])
        for lst, x in zip(outs, (out, attn, h_att.to(cdt), c_att,
                                 h_dec.to(cdt), c_dec,
                                 qsum.reshape(b, -1), ga.to(cdt),
                                 gd.to(cdt))):
            lst.append(x)
    return tuple(torch.stack(lst) for lst in outs)


def train_segments(dims: Dict[str, int]) -> Dict[str, Tuple[int, ...]]:
    """Each re-laid weight matrix's operand segments, in the kernel's
    order (``dims`` as :func:`check_pair_inputs` returns them)."""
    h, e, p = dims["H"], dims["E"], dims["P"]
    return dict(w_att=(p, e, h), w_dec=(h, e, h), wq=(h,), w_heads=(h, e))


def train_weights(ops: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The forward kernel's weights from :func:`kernel_operands`' ``ops``:
    each LSTM's ``[w_ih | w_hh]`` with its gate rows interleaved
    (``ops/decoder_megakernel.py::gate_interleave``), laid out tile-major
    (``tile_major``) in tiles of 16 rows, ``wq`` and ``w_heads`` in tiles
    of 8; the rest as they are.  Made on every call: the weights change at
    every optimizer step."""
    h = ops["wh_a"].shape[1]
    e = ops["wi_d"].shape[1] - h
    seg = train_segments(dict(H=h, E=e, P=ops["wi_a"].shape[1] - e))
    out = {n: ops[n] for n in ("wloc", "b_a", "b_d", "b_heads", "v", "scal")}
    for name, (wi, wh) in dict(w_att=("wi_a", "wh_a"),
                               w_dec=("wi_d", "wh_d")).items():
        out[name] = tile_major(gate_interleave(torch.cat(
            [ops[wi], ops[wh]], 1)), seg[name], LSTM_TILE_ROWS)
    for name in ("wq", "w_heads"):
        out[name] = tile_major(ops[name], seg[name], TILE_ROWS)
    return out


class _Args(ctypes.Structure):
    """Mirror of ``struct TrainFwdArgs`` in csrc/decoder_train_fwd.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "w_att", "w_dec", "wq", "wloc", "w_heads", "b_a", "b_d", "b_heads",
        "v", "scal", "mem", "pm", "mask", "pre", "mka", "mkd", "frames",
        "attn_s", "ha_s", "ca_s", "hd_s", "cd_s", "qsum_s", "aa_s", "ad_s",
        "ctx_w", "h_att_w", "h_dec_w", "prev", "cum", "pq", "energy",
        "bar")]
        + [(n, ctypes.c_int) for n in (
            "B", "T", "H", "P", "E", "A", "M", "K", "S")]
        + [("keep_a", ctypes.c_float), ("keep_d", ctypes.c_float),
           ("grid_blocks", ctypes.c_int)])


def fwd_smem(t_enc: int, a: int, taps: int, cdt: torch.dtype
             ) -> Tuple[int, bool]:
    """``fwd_smem`` of ``csrc/decoder_train_fwd.cu`` as ``(bytes,
    resident)``: the product ring at a batch tile of 16, then the location
    matrix (where it fits), the reductions, attention row and location
    windows."""
    warps = 8
    tail = (up16(32 * 4) + up16(warps * 32 * 4) + up16(t_enc * 4)
            + up16(warps * 2 * taps * 4))
    return location_layout(ring_bytes(16), tail, a, taps, cdt)


def _lib() -> ctypes.CDLL:
    lib = _build.load("decoder_train_fwd")
    lib.t2_decoder_train_fwd.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
    lib.t2_decoder_train_fwd.restype = ctypes.c_int
    lib.t2_decoder_train_fwd_args_size.argtypes = []
    lib.t2_decoder_train_fwd_args_size.restype = ctypes.c_int
    lib.t2_decoder_train_fwd_tile_rows.argtypes = [ctypes.c_int]
    lib.t2_decoder_train_fwd_tile_rows.restype = ctypes.c_int
    lib.t2_decoder_train_fwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.t2_decoder_train_fwd_smem_bytes.restype = ctypes.c_int
    if (lib.t2_decoder_train_fwd_tile_rows(0),
            lib.t2_decoder_train_fwd_tile_rows(1)) != (TILE_ROWS,
                                                       LSTM_TILE_ROWS):
        raise RuntimeError("weight tile rows differ between csrc/"
                           "decoder_train_fwd.cu and ops/decoder_megakernel.py")
    if lib.t2_decoder_train_fwd_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("TrainFwdArgs layout differs between csrc/"
                           "decoder_train_fwd.cu and "
                           "ops/decoder_train_kernel.py")
    return lib


def check_pair_inputs(name: str, cfg: ModelConfig,
                      ops: Dict[str, torch.Tensor], memory: torch.Tensor,
                      t_dec: int) -> Dict[str, int]:
    """The checks both kernels of the pair share; returns the config's
    widths (the kernels run at ``kernel_widths``)."""
    dims = dict(H=cfg.decoder_rnn_dim, P=cfg.prenet_dim,
                E=cfg.encoder_embedding_dim, A=cfg.attention_dim,
                M=cfg.n_mels)
    if memory.ndim != 3 or memory.shape[2] != dims["E"] \
            or cfg.attention_rnn_dim != dims["H"]:
        raise ValueError(f"{name}: memory width or attention rnn dim does "
                         "not match the config")
    cdt = ops["wi_a"].dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: weight dtype {cdt}")
    if t_dec < 1:
        raise ValueError(f"{name}: needs at least one decoder step")
    for x in ops.values():
        if x.device != memory.device:
            raise ValueError(f"{name}: weights and memory on different "
                             "devices")
    return dims


def check_keep_mask(name: str, mk: Optional[torch.Tensor], keep: float,
                    shape, like: torch.Tensor) -> torch.Tensor:
    """A (T, B, H) keep-mask as bytes; where the rate is 0 the kernel reads
    none, and any valid pointer stands in."""
    if keep >= 1.0:
        return like
    if mk is None or tuple(mk.shape) != tuple(shape) \
            or mk.device != like.device:
        raise ValueError(f"{name}: dropout is on and needs a {tuple(shape)} "
                         "keep-mask on the inputs' device")
    return mk.to(torch.uint8).contiguous()


def pad_series(x: torch.Tensor, kind: str, dims: Dict[str, int],
               kd: Dict[str, int]) -> torch.Tensor:
    """A series at the config's widths ``dims`` zero-padded to the
    kernels' ``kd``.  ``kind``: a width's letter (the last dim), ``"4H"``
    (LSTM gates in PyTorch's order), ``"TA"`` (T_enc blocks of A) or
    ``"M+1"`` (mels then the gate)."""
    if dims == kd:
        return x
    if kind == "4H":
        return pad_gates(x, dims["H"], kd["H"])
    if kind == "TA":
        lead = x.shape[:-1]
        a, ak = dims["A"], kd["A"]
        return pad_to(x.reshape(*lead, -1, a), ak).reshape(*lead, -1)
    if kind == "M+1":
        m = dims["M"]
        return torch.cat([pad_to(x[..., :m], kd["M"]), x[..., m:]], -1)
    return pad_to(x, kd[kind])


def unpad_series(x: torch.Tensor, kind: str, dims: Dict[str, int],
                 kd: Dict[str, int]) -> torch.Tensor:
    """The inverse of :func:`pad_series`, contiguous."""
    if dims == kd:
        return x
    if kind == "4H":
        return unpad_gates(x, dims["H"], kd["H"]).contiguous()
    if kind == "TA":
        lead = x.shape[:-1]
        return x.reshape(*lead, -1, kd["A"])[..., :dims["A"]].reshape(
            *lead, -1)
    if kind == "M+1":
        return torch.cat([x[..., :dims["M"]], x[..., kd["M"]:]], -1)
    return x[..., :dims[kind]].contiguous()


def decoder_fwd_train_mega(
        cfg: ModelConfig, ops: Dict[str, torch.Tensor],
        prenet_tbd: torch.Tensor, memory: torch.Tensor, pm: torch.Tensor,
        mask: torch.Tensor, mka_s: Optional[torch.Tensor],
        mkd_s: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Same signature and returns as :func:`decoder_fwd_train_reference`.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise), at ``kernel_widths``.  ``decoder_fwd_train_mega.launches``
    counts launches.
    """
    name = "decoder_fwd_train_mega"
    if memory.device.type == "cpu":
        return decoder_fwd_train_reference(cfg, ops, prenet_tbd, memory, pm,
                                           mask, mka_s, mkd_s)
    if memory.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {memory.device}")
    t_dec, b, _ = prenet_tbd.shape
    t_enc = memory.shape[1]
    dims = check_pair_inputs(name, cfg, ops, memory, t_dec)
    kd = kernel_widths(cfg)
    H, M, A = kd["H"], kd["M"], kd["A"]
    dev, cdt = memory.device, ops["wi_a"].dtype
    if (prenet_tbd.shape != (t_dec, b, dims["P"]) or memory.shape[0] != b
            or pm.shape != (b, t_enc, dims["A"]) or mask.shape != (b, t_enc)
            or mask.dtype != torch.bool
            or any(x.device != dev for x in (prenet_tbd, pm, mask))):
        raise ValueError(f"{name}: shape, dtype or device mismatch: prenet "
                         f"{tuple(prenet_tbd.shape)}, memory "
                         f"{tuple(memory.shape)}, pm {tuple(pm.shape)}, "
                         f"mask {tuple(mask.shape)} {mask.dtype}")
    keep_a = 1.0 - cfg.p_attention_dropout
    keep_d = 1.0 - cfg.p_decoder_dropout
    e = lambda *shape, dtype=torch.float32: torch.empty(*shape, device=dev,
                                                        dtype=dtype)
    z = lambda *shape, dtype=torch.float32: torch.zeros(*shape, device=dev,
                                                        dtype=dtype)
    out = dict(frames=e(t_dec, b, M + 1), attn_s=e(t_dec, b, t_enc),
               ha_s=e(t_dec, b, H, dtype=cdt), ca_s=e(t_dec, b, H),
               hd_s=e(t_dec, b, H, dtype=cdt), cd_s=e(t_dec, b, H),
               qsum_s=e(t_dec, b, t_enc * A, dtype=cdt),
               aa_s=e(t_dec, b, 4 * H, dtype=cdt),
               ad_s=e(t_dec, b, 4 * H, dtype=cdt))
    pad = lambda x, kind: pad_series(x, kind, dims, kd).contiguous()
    ins = dict(
        mem=pad(memory.detach().to(cdt), "E"),
        pm=pad(pm.detach().float(), "A"),
        mask=mask.contiguous().view(torch.uint8),
        pre=pad(prenet_tbd.detach().to(cdt), "P"))
    for key, mk, keep in (("mka", mka_s, keep_a), ("mkd", mkd_s, keep_d)):
        ins[key] = check_keep_mask(name, mk, keep, (t_dec, b, dims["H"]),
                                   ins["mask"])
        if keep < 1.0:
            ins[key] = pad(ins[key], "H")
    scratch = dict(ctx_w=z(2, b, kd["E"], dtype=cdt),
                   h_att_w=z(2, b, H, dtype=cdt),
                   h_dec_w=z(2, b, H, dtype=cdt), prev=z(b, t_enc),
                   cum=z(b, t_enc), pq=e(b, A), energy=e(b, t_enc),
                   bar=z(1, dtype=torch.int32))
    tensors = {**train_weights(pad_operands(ops, dims, kd)), **ins, **out,
               **scratch}
    args = _Args(**{k: v.data_ptr() for k, v in tensors.items()},
                 B=b, T=t_enc, K=cfg.location_kernel_size, S=t_dec,
                 keep_a=keep_a, keep_d=keep_d, **kd)
    err = _lib().t2_decoder_train_fwd(
        ctypes.byref(args), int(cdt == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    decoder_fwd_train_mega.launches += 1
    decoder_fwd_train_mega.last_grid_blocks = args.grid_blocks
    kinds = dict(frames="M+1", ha_s="H", ca_s="H", hd_s="H", cd_s="H",
                 qsum_s="TA", aa_s="4H", ad_s="4H")
    return tuple(unpad_series(x, kinds[k], dims, kd) if k in kinds else x
                 for k, x in out.items())


decoder_fwd_train_mega.launches = 0
decoder_fwd_train_mega.last_grid_blocks = 0
