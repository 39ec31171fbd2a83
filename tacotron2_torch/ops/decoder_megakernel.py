"""Whole-decode kernel: the eval-mode autoregressive decode as one launch.

Replaces the Pallas kernel ``tacotron2_tpu/ops/decoder_megakernel.py::
decoder_infer_mega``.  The CUDA C++ kernel (``csrc/decoder_infer.cu``) is a
persistent cooperative kernel whose time loop runs on the card; its source
note describes the design and its bound (the decoder weights read once per
step: ~10.9 us per step in bf16, ~21.7 us in fp32 on an H100 SXM at
3.35 TB/s).  The plain version, :func:`decoder_infer_mega_reference`, is
the step loop of ``models/decoder.py`` with the plain attention tail.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.decoder import Decoder
from . import _build


class _Args(ctypes.Structure):
    """Mirror of ``struct DecoderArgs`` in csrc/decoder_infer.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "pw1", "pw2", "wi_a", "wh_a", "wi_d", "wh_d", "wq", "wloc",
        "w_heads", "b_a", "b_d", "b_heads", "v", "scal", "mem", "pm", "mask",
        "mels", "gates", "aligns", "ends", "n_frames",
        "h_att", "c_att", "h_dec", "c_dec", "ctx", "prev", "cum", "mel",
        "p1", "p2", "pq", "energy", "done", "item_end", "flags")]
        + [(n, ctypes.c_int) for n in (
            "B", "T", "H", "P", "E", "A", "M", "K",
            "max_steps", "drop_first", "stop_all", "forced_stop_at")]
        + [("gate_threshold", ctypes.c_float), ("grid_blocks", ctypes.c_int)])


def _lib() -> ctypes.CDLL:
    lib = _build.load("decoder_infer")
    lib.t2_decoder_infer.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.t2_decoder_infer.restype = ctypes.c_int
    lib.t2_decoder_args_size.restype = ctypes.c_int
    if lib.t2_decoder_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("DecoderArgs layout differs between csrc/"
                           "decoder_infer.cu and ops/decoder_megakernel.py")
    return lib


def decoder_infer_mega_reference(dec: Decoder, memory: torch.Tensor,
                                 max_steps: int, gate_threshold: float,
                                 drop_first_frame: bool = True,
                                 mask: Optional[torch.Tensor] = None,
                                 stop_mode: str = "any",
                                 forced_stop_at: Optional[int] = None):
    """Plain PyTorch version: the step loop with the plain attention tail."""
    from ..models.decoder import decoder_infer_steps
    from .attention_kernel import attention_tail_reference
    return decoder_infer_steps(dec, memory, max_steps, gate_threshold,
                               drop_first_frame, mask, stop_mode,
                               forced_stop_at, tail=attention_tail_reference)


def _weights(dec: Decoder) -> dict:
    """The kernel's per-step weight operands: weight-dtype matrices in
    PyTorch layout, fp32 biases, the composed location matrix."""
    att = dec.attention
    cdt = dec.attention_lstm.weight_ih.dtype
    w = lambda x: x.detach().to(cdt).contiguous()
    f = lambda x: x.detach().float().contiguous()
    lw = att.location_conv.weight.float()                 # (F, 2, K)
    f_, _, k = lw.shape
    wl = lw.permute(1, 2, 0).reshape(2 * k, f_)           # (2K, F)
    wloc = wl @ att.location_dense.weight.float().t()     # (2K, A)
    return dict(
        pw1=w(dec.prenet[0].weight), pw2=w(dec.prenet[1].weight),
        wi_a=w(dec.attention_lstm.weight_ih),
        wh_a=w(dec.attention_lstm.weight_hh),
        wi_d=w(dec.decoder_lstm.weight_ih),
        wh_d=w(dec.decoder_lstm.weight_hh),
        wq=w(att.query_layer.weight), wloc=w(wloc),
        w_heads=w(torch.cat([dec.linear_projection.weight,
                             dec.gate_layer.weight])),
        b_a=f(dec.attention_lstm.bias_ih.float()
              + dec.attention_lstm.bias_hh.float()),
        b_d=f(dec.decoder_lstm.bias_ih.float()
              + dec.decoder_lstm.bias_hh.float()),
        b_heads=f(torch.cat([dec.linear_projection.bias,
                             dec.gate_layer.bias]).float()),
        v=f(att.v.weight[0]),
        scal=f(torch.stack([att.v.bias[0].float(),
                            att.energy_scale.float()])))


def weight_bytes(dec: Decoder) -> int:
    """Bytes of weights the kernel reads in every decode step."""
    return sum(x.numel() * x.element_size() for x in _weights(dec).values())


def decoder_infer_mega(dec: Decoder, memory: torch.Tensor, max_steps: int,
                       gate_threshold: float, drop_first_frame: bool = True,
                       mask: Optional[torch.Tensor] = None,
                       stop_mode: str = "any",
                       forced_stop_at: Optional[int] = None):
    """Same signature and returns as ``models.decoder.decoder_infer``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise).  ``decoder_infer_mega.launches`` counts launches.
    """
    if memory.device.type == "cpu":
        return decoder_infer_mega_reference(
            dec, memory, max_steps, gate_threshold, drop_first_frame, mask,
            stop_mode, forced_stop_at)
    if memory.device.type != "cuda":
        raise ValueError(f"decoder_infer_mega: unsupported device "
                         f"{memory.device}")
    if stop_mode not in ("any", "all"):
        raise ValueError(f"stop_mode must be 'any' or 'all', got {stop_mode}")
    cfg = dec.cfg
    b, t_enc, e = memory.shape
    dims = dict(H=cfg.decoder_rnn_dim, P=cfg.prenet_dim,
                E=cfg.encoder_embedding_dim, A=cfg.attention_dim,
                M=cfg.n_mels)
    if e != dims["E"] or cfg.attention_rnn_dim != dims["H"]:
        raise ValueError("decoder_infer_mega: memory width or attention "
                         "rnn dim does not match the config")
    if any(v % 8 for v in dims.values()):
        raise ValueError(f"decoder_infer_mega needs every width a multiple "
                         f"of 8 (16-byte vector loads), got {dims}")
    cdt = dec.attention_lstm.weight_ih.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decoder_infer_mega: weight dtype {cdt}")
    if max_steps < 1:
        raise ValueError("decoder_infer_mega: max_steps must be >= 1")
    dev = memory.device
    if dec.attention_lstm.weight_ih.device != dev:
        raise ValueError("decoder_infer_mega: weights and memory on "
                         "different devices")
    ops = _weights(dec)
    ops["mem"] = memory.detach().to(cdt).contiguous()
    ops["pm"] = dec.attention.memory_layer(memory).contiguous()
    if mask is None:
        mask = torch.zeros(b, t_enc, dtype=torch.bool, device=dev)
    if (mask.shape != (b, t_enc) or mask.device != dev
            or mask.dtype != torch.bool):
        raise ValueError("decoder_infer_mega: mask must be a bool (B, T_enc) "
                         "tensor on the memory's device")
    ops["mask"] = mask.contiguous().view(torch.uint8)

    H, M, s = dims["H"], dims["M"], max_steps
    z = lambda *shape: torch.zeros(*shape, device=dev)
    out = dict(mels=z(b, s, M), gates=torch.full((b, s), -1e9, device=dev),
               aligns=z(b, s, t_enc),
               ends=torch.zeros(b, dtype=torch.int32, device=dev),
               n_frames=torch.zeros(1, dtype=torch.int32, device=dev))
    scratch = dict(
        h_att=z(2, b, H), c_att=z(b, H), h_dec=z(2, b, H), c_dec=z(b, H),
        ctx=z(b, dims["E"]), prev=z(b, t_enc), cum=z(b, t_enc), mel=z(b, M),
        p1=z(b, dims["P"]), p2=z(b, dims["P"]), pq=z(b, dims["A"]),
        energy=z(b, t_enc),
        done=torch.zeros(b, dtype=torch.int32, device=dev),
        item_end=torch.full((b,), s, dtype=torch.int32, device=dev),
        flags=torch.zeros(2, dtype=torch.int32, device=dev))
    tensors = {**ops, **out, **scratch}
    args = _Args(**{k: v.data_ptr() for k, v in tensors.items()},
                 B=b, T=t_enc, K=cfg.location_kernel_size, max_steps=s,
                 drop_first=int(drop_first_frame),
                 stop_all=int(stop_mode == "all"),
                 forced_stop_at=(s + 2 if forced_stop_at is None
                                 else int(forced_stop_at)),
                 gate_threshold=float(gate_threshold), **dims)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().t2_decoder_infer(ctypes.byref(args),
                                  int(cdt == torch.bfloat16), dev.index,
                                  stream)
    if err != 0:
        raise RuntimeError(f"decoder_infer_mega: launch failed with CUDA "
                           f"error {err}")
    decoder_infer_mega.launches += 1
    decoder_infer_mega.last_grid_blocks = args.grid_blocks
    return (out["mels"], out["gates"], out["aligns"], out["n_frames"][0],
            out["ends"])


decoder_infer_mega.launches = 0
decoder_infer_mega.last_grid_blocks = 0
