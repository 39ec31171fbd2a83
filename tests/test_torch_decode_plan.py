"""The decode kernel's host side, on the CPU, without JAX.

``ops/decoder_megakernel.py`` hands the kernel its weights re-laid once per
model (``decode_weights``: the LSTMs' gate rows interleaved, the heads' gate
row first, every matrix tile-major with zero-padded segments) and refuses
what the kernel cannot take (``check_launch``).  These tests hold:

- the re-laid weights to the plain ones, exactly;
- the cache: made once, made again after an in-place write or a new tensor;
- the kernel's sum order: a numpy emulation of the staged, segment-
  restarting walk over the re-laid weights (``csrc/decoder_infer.cu``,
  ``product_tile``) against one of ``warp_dot``'s walk over the plain
  weights (``csrc/decoder_common.cuh``), bit for bit, at small and full
  width;
- the refusals;
- ``chip_smoke.py``'s pick of a gate-bias offset, on the plain step loop.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from tacotron2_torch.config import ModelConfig
from tacotron2_torch.models.tacotron2 import (Tacotron2, cast_params_bf16,
                                              init_weights, make_pad_mask)
from tacotron2_torch.ops.decoder_megakernel import (
    CHUNK_BYTES, LSTM_TILE_ROWS, TILE_ROWS, _relaid, _segments, _weights,
    check_launch, decode_weights, decoder_infer_mega_reference,
    gate_interleave, tile_major)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import expected_ends, gate_stop_offset  # noqa: E402

SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32)
WIDTHS = {"small": SMALL, "full": {}}
DTYPES = [torch.float32, torch.bfloat16]


def decoder(width="small", dtype=torch.float32, seed=0):
    model = init_weights(Tacotron2(ModelConfig(**WIDTHS[width])), seed=seed)
    if dtype == torch.bfloat16:
        model = cast_params_bf16(model)
    return model.decoder


def untile(t: torch.Tensor, widths, n: int) -> torch.Tensor:
    """The inverse of ``tile_major``: the (n, sum(widths)) matrix."""
    tiles, chunks, rows, ce = t.shape
    wp = t.transpose(1, 2).reshape(tiles * rows, chunks * ce)[:n]
    out, off = [], 0
    for k in widths:
        out.append(wp[:, off:off + k])
        off += -(-k // ce) * ce
    return torch.cat(out, 1)


def heads_order(m):
    """The heads' rows as the kernel holds them: the gate's, then the
    projection's."""
    return lambda w: torch.cat([w[m:], w[:m]])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", ["small", "full"])
def test_relaid_weights_give_back_the_plain_ones(width, dtype):
    dec = decoder(width, dtype)
    plain, got = _weights(dec), decode_weights(dec)
    cfg = dec.cfg
    seg = _segments(cfg)
    m, h = cfg.n_mels, cfg.decoder_rnn_dim
    want = dict(
        pw1=plain["pw1"], pw2=plain["pw2"], wq=plain["wq"],
        w_att=gate_interleave(torch.cat([plain["wi_a"], plain["wh_a"]], 1)),
        w_dec=gate_interleave(torch.cat([plain["wi_d"], plain["wh_d"]], 1)),
        w_heads=heads_order(m)(plain["w_heads"]))
    for name, w in want.items():
        t = got[name]
        rows = LSTM_TILE_ROWS if name in ("w_att", "w_dec") else TILE_ROWS
        assert t.dtype == dtype and t.is_contiguous()
        assert t.shape[2:] == (rows, CHUNK_BYTES // t.element_size())
        assert torch.equal(untile(t, seg[name], w.shape[0]), w), name
        # the padding is zeros
        pad = tile_major(torch.ones_like(w), seg[name], rows) == 0
        assert not t[pad].any()
    # interleaving: row 4j + g is gate g of unit j
    for g in range(4):
        assert torch.equal(want["w_att"][g::4], torch.cat(
            [plain["wi_a"], plain["wh_a"]], 1)[g * h:(g + 1) * h])
    assert torch.equal(got["b_heads"], heads_order(m)(plain["b_heads"]))
    for name in ("wloc", "b_a", "b_d", "v", "scal"):
        assert torch.equal(got[name], plain[name])


@pytest.mark.parametrize("widths,rows", [((8,), 8), ((16, 32, 64), 16),
                                         ((80,), 8), ((1024, 512), 8)])
def test_tile_major_round_trip(widths, rows):
    g = torch.Generator().manual_seed(sum(widths))
    n = 3 * rows + 5
    w = torch.randn(n, sum(widths), generator=g).to(torch.bfloat16)
    t = tile_major(w, widths, rows)
    ce = CHUNK_BYTES // 2
    assert t.shape == (-(-n // rows), sum(-(-k // ce) for k in widths), rows,
                       ce)
    assert torch.equal(untile(t, widths, n), w)


PARAMS = ["prenet.0.weight", "attention_lstm.weight_hh",
          "decoder_lstm.bias_ih", "gate_layer.bias",
          "attention.location_conv.weight", "attention.energy_scale"]


@pytest.mark.parametrize("name", PARAMS)
def test_decode_weights_made_once_and_after_a_write(name):
    dec = decoder()
    first = decode_weights(dec)
    assert decode_weights(dec) is first
    with torch.no_grad():
        dict(dec.named_parameters())[name].add_(0.5)
    again = decode_weights(dec)
    assert again is not first and decode_weights(dec) is again
    for key, value in _relaid(dec).items():
        assert torch.equal(again[key], value), key


def test_decode_weights_follow_a_new_tensor():
    dec = decoder()
    first = decode_weights(dec)
    state = {k: v.clone() * 2 for k, v in dec.state_dict().items()}
    dec.load_state_dict(state, assign=True)
    again = decode_weights(dec)
    assert again is not first
    assert torch.equal(again["w_att"], _relaid(dec)["w_att"])


# ---------------------------------------------------------------------------
# sum order: the kernel's walk against warp_dot's, in numpy
# ---------------------------------------------------------------------------
def fma(a, b, c):
    """a * b + c in float64, rounded once to float32 (an fp32 FMA, up to the
    rare double rounding; both walks use this same function)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def warp_sum(acc):
    """decoder_common.cuh's warp_sum over the last axis (32 lanes)."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = (acc + acc[..., lanes ^ o]).astype(np.float32)
    return acc[..., 0]


def warp_dot_walk(w, xs, widths, v):
    """warp_dot called once a segment into one accumulator: lane l takes
    elements l*v .. l*v+v-1 of every 32*v of the segment, FMA in k order;
    then warp_sum.  w (n, K), xs[s] (B, k_s): (n, B)."""
    acc = np.zeros((w.shape[0], xs[0].shape[0], 32), np.float32)
    off = 0
    for x, k in zip(xs, widths):
        for base in range(0, k, 32 * v):
            for i in range(v):
                idx = base + np.arange(32) * v + i
                live = idx < k
                idx = np.minimum(idx, k - 1)
                nxt = fma(x[None, :, idx], w[:, None, off + idx], acc)
                acc = np.where(live, nxt, acc)
        off += k
    return warp_sum(acc)


def staged_walk(t, xs, widths, n_rows, v):
    """The kernel's walk over the tile-major weights t (tiles, chunks,
    rows, 32v): chunk ch of the walk is chunk c of segment s, its weight
    pieces t[:, ch, :, l*v:(l+1)*v], lanes past the segment's end adding
    nothing; then warp_sum.  Returns (n_rows, B) in the re-laid row order."""
    tiles, n_chunks, rows, ce = t.shape
    w = t.transpose(0, 2, 1, 3).reshape(tiles * rows, n_chunks, ce)[:n_rows]
    acc = np.zeros((n_rows, xs[0].shape[0], 32), np.float32)
    ch = 0
    for x, k in zip(xs, widths):
        for c in range(-(-k // ce)):
            for i in range(v):
                lane_el = np.arange(32) * v + i
                live = lane_el < k - c * ce
                idx = np.minimum(c * ce + lane_el, k - 1)
                nxt = fma(x[None, :, idx], w[:, ch][:, None, lane_el], acc)
                acc = np.where(live, nxt, acc)
            ch += 1
    assert ch == n_chunks
    return warp_sum(acc)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("name", ["pw1", "pw2", "w_att", "w_dec", "wq",
                                  "w_heads"])
def test_staged_walk_is_warp_dots(name, width, dtype):
    dec = decoder(width, dtype)
    cfg = dec.cfg
    plain, relaid = _weights(dec), decode_weights(dec)
    widths = _segments(cfg)[name]
    h, m = cfg.decoder_rnn_dim, cfg.n_mels
    if name in ("w_att", "w_dec"):
        n = name[2]
        w = torch.cat([plain[f"wi_{n}"], plain[f"wh_{n}"]], 1)
        back = lambda y: y.reshape(h, 4, -1).swapaxes(0, 1).reshape(4 * h, -1)
    elif name == "w_heads":
        w = plain["w_heads"]
        back = lambda y: np.concatenate([y[1:], y[:1]])
    else:
        w = plain[name]
        back = lambda y: y
    rng = np.random.default_rng(len(name) + sum(widths))
    xs = [torch.from_numpy(rng.standard_normal((3, k)).astype(np.float32))
          .to(dtype).float().numpy() for k in widths]
    v = 16 // w.element_size()
    want = warp_dot_walk(w.float().numpy(), xs, widths, v)
    got = staged_walk(relaid[name].float().numpy(), xs, widths, w.shape[0], v)
    np.testing.assert_array_equal(back(got), want)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def launch_args(**change):
    dec = decoder(dtype=change.pop("dtype", torch.float32))
    rng = np.random.default_rng(0)
    memory = torch.from_numpy(rng.standard_normal(
        (2, 12, change.pop("e", 32))).astype(np.float32))
    mask = change.pop("mask", make_pad_mask(torch.tensor([12, 9]), 12))
    args = dict(dec=dec, memory=memory, max_steps=14, mask=mask,
                stop_mode="any")
    args.update(change)
    return args


@pytest.mark.parametrize("change,error,match", [
    (dict(stop_mode="first"), ValueError, "stop_mode"),
    (dict(e=40), ValueError, "memory width"),
    (dict(max_steps=0), ValueError, "max_steps"),
    (dict(mask=torch.zeros(2, 12)), ValueError, "mask"),
    (dict(mask=torch.zeros(2, 11, dtype=torch.bool)), ValueError, "mask"),
    (dict(mask=torch.zeros(3, 12, dtype=torch.bool)), ValueError, "mask"),
])
def test_check_launch_refuses(change, error, match):
    with pytest.raises(error, match=match):
        check_launch(**launch_args(**change))


def test_check_launch_takes_what_it_can():
    check_launch(**launch_args())
    check_launch(**launch_args(mask=None, stop_mode="all"))
    check_launch(**launch_args(dtype=torch.bfloat16))


def test_check_launch_refuses_widths_and_dtypes():
    """Widths that are no multiples of 8 are taken (the wrapper pads them
    to ``kernel_widths``); a memory width or attention rnn dim other than
    the config's, and fp16 weights, are refused."""
    dec = init_weights(Tacotron2(ModelConfig(**dict(SMALL, prenet_dim=12))),
                       seed=0).decoder
    memory = torch.zeros(2, 12, 32)
    check_launch(dec, memory, 14, None, "any")
    with pytest.raises(ValueError, match="memory width"):
        check_launch(dec, torch.zeros(2, 12, 30), 14, None, "any")
    dec.cfg = dataclasses.replace(dec.cfg, attention_rnn_dim=32)
    with pytest.raises(ValueError, match="attention rnn dim"):
        check_launch(dec, memory, 14, None, "any")
    half = decoder().half()
    with pytest.raises(TypeError, match="weight dtype"):
        check_launch(half, memory, 14, None, "any")


# ---------------------------------------------------------------------------
# the gate-fired stop's offset, on the plain step loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_gate_stop_offset_on_the_plain_loop(dtype):
    dec = decoder(dtype=dtype)
    mask = make_pad_mask(torch.tensor([12, 9]), 12)

    def candidates():
        for seed in range(30):
            rng = np.random.default_rng(seed)
            yield torch.from_numpy((rng.standard_normal((2, 12, 32)) * 0.5)
                                   .astype(np.float32)), mask

    picked = gate_stop_offset(dec, candidates(), 40, 0.5, 1e-4, 30,
                              drop_first=False)
    assert picked is not None
    i, offset, hot, stops = picked
    early = [s for s in stops if 0 < s <= 30]
    assert len(set(early)) >= 2
    # the offset went into an fp32 bias of a copy; the rest is the model's
    assert hot.gate_layer.bias.dtype == torch.float32
    assert dec.gate_layer.bias.dtype == dtype
    memory = list(candidates())[i][0]
    for mode in ("any", "all"):
        with torch.no_grad():
            out = decoder_infer_mega_reference(hot, memory, 40, 0.5, False,
                                               mask, mode)
        n, ends = expected_ends(stops, mode, 40)
        assert int(out[3]) == n and out[4].tolist() == ends


def test_expected_ends():
    assert expected_ends([0, 3, 5], "any", 10) == (3, [3, 3, 3])
    assert expected_ends([0, 3, 5], "all", 10) == (10, [10, 3, 5])
    assert expected_ends([4, 3, 5], "all", 10) == (5, [4, 3, 5])
    assert expected_ends([0, 0], "any", 10) == (10, [10, 10])
