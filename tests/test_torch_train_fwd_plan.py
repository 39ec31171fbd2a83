"""The teacher-forced forward kernel's host side, on the CPU, without JAX.

``ops/decoder_train_kernel.py::decoder_fwd_train_mega`` hands the kernel
(``csrc/decoder_train_fwd.cu``) its weights re-laid on every call from
``kernel_operands`` (``train_weights``: the LSTMs' ``[w_ih | w_hh]`` with
their gate rows interleaved, every matrix tile-major with zero-padded
segments).  These tests hold:

- the re-laid weights to ``kernel_operands``' matrices, exactly, at small
  and full width;
- the kernel's sum order: a numpy emulation of the staged, segment-
  restarting walk over the re-laid weights (``product_tile`` in
  ``csrc/decoder_common.cuh``), in passes of the kernel's batch tile of 16
  rows, against one of ``warp_dot``'s walk over ``kernel_operands``'
  matrices (the design before this one), bit for bit, for the four
  products ``[pre | ctx | h_att]``, ``[h_att | ctx | h_dec]``, ``[h_att]``
  and ``[h_dec | ctx]``, ragged small segments included.
"""

import numpy as np
import pytest
import torch

from tacotron2_torch.config import ModelConfig
from tacotron2_torch.models.tacotron2 import (Tacotron2, cast_params_bf16,
                                              init_weights)
from tacotron2_torch.ops.decoder_bptt import core_params
from tacotron2_torch.ops.decoder_megakernel import (CHUNK_BYTES,
                                                    LSTM_TILE_ROWS,
                                                    TILE_ROWS,
                                                    gate_interleave,
                                                    tile_major)
from tacotron2_torch.ops.decoder_train_kernel import (kernel_operands,
                                                      train_segments,
                                                      train_weights)
from test_torch_decode_plan import (SMALL, staged_walk, untile,
                                    warp_dot_walk)

WIDTHS = {"small": SMALL, "full": {}}
DTYPES = [torch.float32, torch.bfloat16]
BATCH_TILE = 16     # csrc/decoder_train_fwd.cu, kFwdMTile


def operands(width="small", dtype=torch.float32):
    model = init_weights(Tacotron2(ModelConfig(**WIDTHS[width])), seed=0)
    if dtype == torch.bfloat16:
        model = cast_params_bf16(model)
    return model.cfg, kernel_operands(core_params(model.decoder))


def dims_of(cfg):
    return dict(H=cfg.decoder_rnn_dim, P=cfg.prenet_dim,
                E=cfg.encoder_embedding_dim, A=cfg.attention_dim,
                M=cfg.n_mels)


def plain_rows(ops, name):
    """The matrix that a re-laid weight holds, in the kernel's row order:
    the LSTMs' ``[w_ih | w_hh]`` gate-interleaved, the others as they
    are."""
    if name in ("w_att", "w_dec"):
        n = name[2]
        return gate_interleave(torch.cat([ops[f"wi_{n}"], ops[f"wh_{n}"]],
                                         1))
    return ops[name]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", ["small", "full"])
def test_train_weights_give_back_the_operands(width, dtype):
    cfg, ops = operands(width, dtype)
    got = train_weights(ops)
    seg = train_segments(dims_of(cfg))
    h = cfg.decoder_rnn_dim
    for name in ("w_att", "w_dec", "wq", "w_heads"):
        w, t = plain_rows(ops, name), got[name]
        rows = LSTM_TILE_ROWS if name in ("w_att", "w_dec") else TILE_ROWS
        assert t.dtype == dtype and t.is_contiguous()
        assert t.shape[2:] == (rows, CHUNK_BYTES // t.element_size())
        assert torch.equal(untile(t, seg[name], w.shape[0]), w), name
        pad = tile_major(torch.ones_like(w), seg[name], rows) == 0
        assert not t[pad].any(), name
    # interleaving: row 4j + g of w_att is gate g of unit j of w_ih | w_hh
    wa = torch.cat([ops["wi_a"], ops["wh_a"]], 1)
    for g in range(4):
        assert torch.equal(plain_rows(ops, "w_att")[g::4],
                           wa[g * h:(g + 1) * h])
    for name in ("wloc", "b_a", "b_d", "b_heads", "v", "scal"):
        assert got[name] is ops[name]
    assert set(got) == {"w_att", "w_dec", "wq", "w_heads", "wloc", "b_a",
                        "b_d", "b_heads", "v", "scal"}


def sample_tiles(t: torch.Tensor, w: torch.Tensor, rows: int):
    """At most three tiles (first, second, last) of a re-laid matrix and
    the plain rows they hold, so that full width stays quick."""
    n_tiles = t.shape[0]
    pick = sorted({0, min(1, n_tiles - 1), n_tiles - 1})
    plain = torch.cat([w[i * rows:(i + 1) * rows] for i in pick])
    return t[pick], plain


@pytest.mark.parametrize("b", [16, 9, 24])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("name", ["w_att", "w_dec", "wq", "w_heads"])
def test_staged_walk_in_batch_tiles_is_warp_dots(name, width, dtype, b):
    """The kernel's sums, a pass of up to 16 batch rows at a time, are
    warp_dot's over the plain matrices: one warp_dot a segment into one
    accumulator."""
    cfg, ops = operands(width, dtype)
    widths = train_segments(dims_of(cfg))[name]
    rows = LSTM_TILE_ROWS if name in ("w_att", "w_dec") else TILE_ROWS
    t, w = sample_tiles(train_weights(ops)[name], plain_rows(ops, name),
                        rows)
    n = w.shape[0]
    rng = np.random.default_rng(b + len(name) + sum(widths))
    # the operand segments as the kernel holds them: rounded to W once
    xs = [torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32))
          .to(dtype).float().numpy() for k in widths]
    v = 16 // w.element_size()
    want = warp_dot_walk(w.float().numpy(), xs, widths, v)
    got = np.concatenate([
        staged_walk(t.float().numpy(), [x[m0:m0 + BATCH_TILE] for x in xs],
                    widths, n, v)
        for m0 in range(0, b, BATCH_TILE)], axis=1)
    np.testing.assert_array_equal(got, want)
