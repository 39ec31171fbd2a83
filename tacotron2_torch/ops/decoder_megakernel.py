"""Whole-decode kernel: the eval-mode autoregressive decode as one launch.

Replaces the Pallas kernel ``tacotron2_tpu/ops/decoder_megakernel.py::
decoder_infer_mega``.  The CUDA C++ kernel (``csrc/decoder_infer.cu``) is a
persistent cooperative kernel whose time loop runs on the card; its source
note describes the design and its bound (the decoder weights read once per
step: ~10.9 us per step in bf16, ~21.7 us in fp32 on an H100 SXM at
3.35 TB/s).  The kernel reads its weights in the layout
:func:`decode_weights` makes once per model and keeps.  The plain version,
:func:`decoder_infer_mega_reference`, is the step loop of
``models/decoder.py`` with the plain attention tail.

The kernel's widths are multiples of 8 (16-byte vector loads).  Where a
config's are not, :func:`pad_operands` zero-pads the weights to
:func:`kernel_widths` once with the re-layout, and the wrapper pads the
memory and slices the mels: the padded units of each LSTM stay 0 (zero
weights and bias: i = f = o = 1/2, g = 0, from a zero cell), the padded
columns of every product meet zero weights, so each sum only gains zero
terms.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.decoder import Decoder
from . import _build


class _Args(ctypes.Structure):
    """Mirror of ``struct DecoderArgs`` in csrc/decoder_infer.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "pw1", "pw2", "w_att", "w_dec", "wq", "wloc", "w_heads", "b_a", "b_d",
        "b_heads", "v", "scal", "mem", "pm", "mask",
        "mels", "gates", "aligns", "ends", "n_frames",
        "mel_w", "p1_w", "p2_w", "ctx_w", "h_att_w", "h_dec_w", "c_att",
        "c_dec", "prev", "cum", "pq", "energy", "flags", "bar")]
        + [(n, ctypes.c_int) for n in (
            "B", "T", "H", "P", "E", "A", "M", "K",
            "max_steps", "drop_first", "stop_all", "forced_stop_at")]
        + [("gate_threshold", ctypes.c_float), ("grid_blocks", ctypes.c_int)])


# constants of csrc/decoder_common.cuh: a block's shared memory may take
# kSmemLimit bytes; kWarps; the ring of a product (ring_bytes, res_bytes
# and its kRingMaxStages mbarriers) by batch tile
SMEM_LIMIT = 232448
_WARPS = 8
_CHUNK_BYTES = 512


def up16(n: int) -> int:
    return -(-n // 16) * 16


def ring_bytes(m_tile: int) -> int:
    """A product's ring, its results and its mbarriers: the shared memory
    before a decoder kernel's location matrix, at a batch tile of
    ``m_tile`` rows."""
    stages = max(2 * (2 * _WARPS + m_tile), 3 * (_WARPS + m_tile))
    return (stages * _CHUNK_BYTES + m_tile * 2 * _WARPS * 4
            + up16(3 * 8))


def location_layout(head: int, tail: int, a: int, taps: int,
                    cdt: torch.dtype) -> Tuple[int, bool]:
    """``(bytes, resident)``: a decoder kernel's dynamic shared memory and
    whether its composed (2K, A) location matrix is in it.  ``head``: the
    bytes before the matrix, ``tail``: after it.  Resident where the whole
    fits ``SMEM_LIMIT``; else the kernel reads the matrix from L2."""
    with_wl = head + up16(2 * taps * a * cdt.itemsize) + tail
    return (with_wl, True) if with_wl <= SMEM_LIMIT else (head + tail, False)


def decode_smem(b: int, t_enc: int, a: int, taps: int,
                cdt: torch.dtype) -> Tuple[int, bool]:
    """``smem_layout`` of ``csrc/decoder_infer.cu``: the product ring at
    a batch tile of 8, then the location matrix, then the reductions,
    attention row, gates, stop flags and location windows."""
    tail = (up16(32 * 4) + up16(_WARPS * 32 * 4) + up16(t_enc * 4)
            + up16(b * 4) + up16(2 * b * 4) + up16(_WARPS * 2 * taps * 4))
    return location_layout(ring_bytes(8), tail, a, taps, cdt)


def _lib() -> ctypes.CDLL:
    lib = _build.load("decoder_infer")
    lib.t2_decoder_infer.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.t2_decoder_infer.restype = ctypes.c_int
    lib.t2_decoder_args_size.restype = ctypes.c_int
    lib.t2_decoder_infer_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.t2_decoder_infer_smem_bytes.restype = ctypes.c_int
    lib.t2_decoder_infer_tile_rows.argtypes = [ctypes.c_int]
    lib.t2_decoder_infer_tile_rows.restype = ctypes.c_int
    if (lib.t2_decoder_infer_tile_rows(0), lib.t2_decoder_infer_tile_rows(1)
            ) != (TILE_ROWS, LSTM_TILE_ROWS):
        raise RuntimeError("weight tile rows differ between csrc/"
                           "decoder_infer.cu and ops/decoder_megakernel.py")
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


def _widths(cfg) -> Dict[str, int]:
    return dict(H=cfg.decoder_rnn_dim, P=cfg.prenet_dim,
                E=cfg.encoder_embedding_dim, A=cfg.attention_dim,
                M=cfg.n_mels)


def kernel_widths(cfg) -> Dict[str, int]:
    """The widths H, P, E, A, M the decoder kernels run at: the config's,
    each rounded up to a multiple of 8."""
    return {k: -(-v // 8) * 8 for k, v in _widths(cfg).items()}


def pad_to(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x`` zero-padded at the end of its last ``len(sizes)`` dims to
    ``sizes``; ``x`` itself where nothing grows."""
    pads = []
    for n, size in zip(reversed(x.shape), reversed(sizes)):
        pads += [0, size - n]
    return F.pad(x, pads) if any(pads) else x


def pad_gates(x: torch.Tensor, h: int, hk: int) -> torch.Tensor:
    """(..., 4h) in PyTorch's gate order (i, f, g, o blocks of h) ->
    (..., 4hk), each block zero-padded to hk."""
    if h == hk:
        return x
    lead = x.shape[:-1]
    return pad_to(x.reshape(*lead, 4, h), 4, hk).reshape(*lead, 4 * hk)


def unpad_gates(x: torch.Tensor, h: int, hk: int) -> torch.Tensor:
    """The inverse of :func:`pad_gates`: (..., 4hk) -> (..., 4h)."""
    if h == hk:
        return x
    lead = x.shape[:-1]
    return x.reshape(*lead, 4, hk)[..., :h].reshape(*lead, 4 * h)


def _pad_cols(w: torch.Tensor, widths: Sequence[int],
              widths_k: Sequence[int]) -> torch.Tensor:
    """(n, sum(widths)) -> (n, sum(widths_k)), each column segment
    zero-padded."""
    if tuple(widths) == tuple(widths_k):
        return w
    return torch.cat([pad_to(x, k) for x, k in
                      zip(w.split(list(widths), 1), widths_k)], 1)


def pad_operands(ops: Dict[str, torch.Tensor], dims: Dict[str, int],
                 kd: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """The weight operands (keys of :func:`_weights` or
    ``ops/decoder_train_kernel.py::kernel_operands``, PyTorch layout) at
    the config's widths ``dims``, zero-padded to the kernel's ``kd``
    (:func:`kernel_widths`); ``ops`` itself where the two agree."""
    if dims == kd:
        return ops
    h, hk, m, mk = dims["H"], kd["H"], dims["M"], kd["M"]

    def cols(w, *names):
        return _pad_cols(w, [dims[n] for n in names], [kd[n] for n in names])

    def lstm(w, *names):        # (4H, K): gate rows, column segments
        return pad_gates(cols(w, *names).t(), h, hk).t()

    heads = lambda x: torch.cat([pad_to(x[:m], mk, *x.shape[1:]), x[m:]])
    out = dict(
        wi_a=lstm(ops["wi_a"], "P", "E"), wh_a=lstm(ops["wh_a"], "H"),
        wi_d=lstm(ops["wi_d"], "H", "E"), wh_d=lstm(ops["wh_d"], "H"),
        wq=pad_to(ops["wq"], kd["A"], hk),
        wloc=pad_to(ops["wloc"], kd["A"]),
        w_heads=heads(cols(ops["w_heads"], "H", "E")),
        b_a=pad_gates(ops["b_a"], h, hk), b_d=pad_gates(ops["b_d"], h, hk),
        b_heads=heads(ops["b_heads"]), v=pad_to(ops["v"], kd["A"]),
        scal=ops["scal"])
    if "pw1" in ops:
        out["pw1"] = pad_to(ops["pw1"], kd["P"], mk)
        out["pw2"] = pad_to(ops["pw2"], kd["P"], kd["P"])
    return {k: v.contiguous() for k, v in out.items()}


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


def gate_interleave(w: torch.Tensor) -> torch.Tensor:
    """(4H, K) in PyTorch's gate order (rows g*H + j) -> rows 4j + g, so
    that four neighbouring rows are the i, f, g, o gates of one unit."""
    four_h, k = w.shape
    return w.reshape(4, four_h // 4, k).transpose(0, 1).reshape(four_h, k)


CHUNK_BYTES = 512      # a chunk of a weight row: 16 bytes a lane of a warp
TILE_ROWS = 8          # weight rows of a block's tile: one a warp
LSTM_TILE_ROWS = 16    # the LSTMs': two a warp, the gates of four units


def tile_major(w: torch.Tensor, widths, rows: int) -> torch.Tensor:
    """(n, sum(widths)) -> (tiles, chunks, rows, CHUNK_BYTES / itemsize):
    each segment of ``widths`` zero-padded to whole chunks, the rows to
    whole tiles, and a tile's chunk made contiguous, as the kernel copies
    it."""
    ce = CHUNK_BYTES // w.element_size()
    pad = torch.nn.functional.pad
    if any(k % ce for k in widths):      # (copies only where it pads)
        w = torch.cat([pad(x, (0, -x.shape[1] % ce))
                       for x in w.split(list(widths), 1)], 1)
    if w.shape[0] % rows:
        w = pad(w, (0, 0, 0, -w.shape[0] % rows))
    return (w.reshape(w.shape[0] // rows, rows, w.shape[1] // ce, ce)
            .transpose(1, 2).contiguous())


def _segments(cfg) -> dict:
    """Each weight matrix's operand segments at the kernel's widths
    (:func:`kernel_widths`), in the kernel's order."""
    kd = kernel_widths(cfg)
    h, e, p = kd["H"], kd["E"], kd["P"]
    return dict(pw1=(kd["M"],), pw2=(p,), w_att=(p, e, h),
                w_dec=(h, e, h), wq=(h,), w_heads=(h, e))


def _relaid(dec: Decoder) -> dict:
    """:func:`_weights` padded to :func:`kernel_widths` and in the
    kernel's layout (see :func:`decode_weights`)."""
    kd = kernel_widths(dec.cfg)
    ops = dict(pad_operands(_weights(dec), _widths(dec.cfg), kd))
    for name in ("att", "dec"):
        wi, wh = ops.pop(f"wi_{name[0]}"), ops.pop(f"wh_{name[0]}")
        ops[f"w_{name}"] = gate_interleave(torch.cat([wi, wh], 1))
    m = kd["M"]
    ops["w_heads"] = torch.cat([ops["w_heads"][m:], ops["w_heads"][:m]])
    ops["b_heads"] = torch.cat([ops["b_heads"][m:], ops["b_heads"][:m]])
    for name, widths in _segments(dec.cfg).items():
        rows = LSTM_TILE_ROWS if name in ("w_att", "w_dec") else TILE_ROWS
        ops[name] = tile_major(ops[name], widths, rows)
    return ops


_PLANS: "weakref.WeakKeyDictionary[Decoder, tuple]" = \
    weakref.WeakKeyDictionary()


@torch.no_grad()
def decode_weights(dec: Decoder) -> dict:
    """The kernel's weight operands, made once and kept while nothing they
    were made from changes: the weight-dtype matrices one row per output,
    the LSTMs' as ``[w_ih | w_hh]`` with the gate rows interleaved
    (:func:`gate_interleave`), the heads' with the gate row first, each
    then laid out tile-major (:func:`tile_major`); the fp32 biases (the
    LSTMs' in PyTorch's gate order, the heads' gate first), ``v``, ``[v
    bias, energy scale]`` and the composed (2K, A) location matrix.

    The key is each of the decoder's parameters' address, version counter,
    dtype and device, and its storage, held by weak reference (as
    ``ops/convbn_kernel.py::folded_weights`` keys the conv fold): an
    in-place write or a new tensor makes them again.  A write through
    ``.data`` bumps no version and is not seen; inference tensors carry no
    version, so their operands are made on every call."""
    tensors = list(dec.parameters())
    if any(t.is_inference() for t in tensors):
        return _relaid(dec)
    key = tuple((t.data_ptr(), t._version, t.dtype, t.device)
                for t in tensors)
    plan = _PLANS.get(dec)
    if plan is None or plan[0] != key or any(
            ref() is not t.untyped_storage()
            for t, ref in zip(tensors, plan[1])):
        plan = (key, tuple(weakref.ref(t.untyped_storage())
                           for t in tensors), _relaid(dec))
        _PLANS[dec] = plan
    return plan[2]


def check_launch(dec: Decoder, memory: torch.Tensor, max_steps: int,
                 mask: Optional[torch.Tensor], stop_mode: str) -> None:
    """Raise on what the kernel does not take: another stop mode, a
    memory width other than the config's, an attention rnn dim other than
    the decoder's (the attention LSTM is ``decoder_rnn_dim`` wide), a
    weight dtype other than fp32 or bf16, ``max_steps`` < 1, weights and
    memory on different devices, a mask that is not a bool (B, T_enc)
    tensor on the memory's device."""
    if stop_mode not in ("any", "all"):
        raise ValueError(f"stop_mode must be 'any' or 'all', got {stop_mode}")
    cfg = dec.cfg
    if memory.ndim != 3:
        raise ValueError(f"decoder_infer_mega: memory {tuple(memory.shape)}")
    b, t_enc, e = memory.shape
    if e != cfg.encoder_embedding_dim \
            or cfg.attention_rnn_dim != cfg.decoder_rnn_dim:
        raise ValueError("decoder_infer_mega: memory width or attention "
                         "rnn dim does not match the config")
    cdt = dec.attention_lstm.weight_ih.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decoder_infer_mega: weight dtype {cdt}")
    if max_steps < 1:
        raise ValueError("decoder_infer_mega: max_steps must be >= 1")
    if dec.attention_lstm.weight_ih.device != memory.device:
        raise ValueError("decoder_infer_mega: weights and memory on "
                         "different devices")
    if mask is not None and (mask.shape != (b, t_enc)
                             or mask.device != memory.device
                             or mask.dtype != torch.bool):
        raise ValueError("decoder_infer_mega: mask must be a bool (B, T_enc) "
                         "tensor on the memory's device")


def decoder_infer_mega(dec: Decoder, memory: torch.Tensor, max_steps: int,
                       gate_threshold: float, drop_first_frame: bool = True,
                       mask: Optional[torch.Tensor] = None,
                       stop_mode: str = "any",
                       forced_stop_at: Optional[int] = None):
    """Same signature and returns as ``models.decoder.decoder_infer``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise), at :func:`kernel_widths`.  ``decoder_infer_mega.launches``
    counts launches.
    """
    if memory.device.type == "cpu":
        return decoder_infer_mega_reference(
            dec, memory, max_steps, gate_threshold, drop_first_frame, mask,
            stop_mode, forced_stop_at)
    if memory.device.type != "cuda":
        raise ValueError(f"decoder_infer_mega: unsupported device "
                         f"{memory.device}")
    check_launch(dec, memory, max_steps, mask, stop_mode)
    cfg = dec.cfg
    b, t_enc, _ = memory.shape
    dims = kernel_widths(cfg)
    cdt = dec.attention_lstm.weight_ih.dtype
    dev = memory.device
    ops = dict(decode_weights(dec))
    ops["mem"] = pad_to(memory.detach().to(cdt), dims["E"]).contiguous()
    ops["pm"] = pad_to(dec.attention.memory_layer(memory),
                       dims["A"]).contiguous()
    if mask is None:
        mask = torch.zeros(b, t_enc, dtype=torch.bool, device=dev)
    ops["mask"] = mask.contiguous().view(torch.uint8)

    H, M, s = dims["H"], dims["M"], max_steps
    z = lambda *shape: torch.zeros(*shape, device=dev)
    out = dict(mels=z(b, s, M), gates=torch.full((b, s), -1e9, device=dev),
               aligns=z(b, s, t_enc),
               ends=torch.zeros(b, dtype=torch.int32, device=dev),
               n_frames=torch.zeros(1, dtype=torch.int32, device=dev))
    zw = lambda *shape: torch.zeros(*shape, dtype=cdt, device=dev)
    scratch = dict(
        mel_w=zw(b, M), p1_w=zw(b, dims["P"]), p2_w=zw(b, dims["P"]),
        ctx_w=zw(b, dims["E"]), h_att_w=zw(2, b, H), h_dec_w=zw(2, b, H),
        c_att=z(b, H), c_dec=z(b, H), prev=z(b, t_enc), cum=z(b, t_enc),
        pq=z(b, dims["A"]), energy=z(b, t_enc),
        flags=torch.zeros(2, dtype=torch.int32, device=dev),
        bar=torch.zeros(1, dtype=torch.int32, device=dev))
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
    mels = out["mels"]
    if M != cfg.n_mels:
        mels = mels[..., :cfg.n_mels].contiguous()
    return mels, out["gates"], out["aligns"], out["n_frames"][0], out["ends"]


decoder_infer_mega.launches = 0
decoder_infer_mega.last_grid_blocks = 0
