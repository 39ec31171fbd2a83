"""The count functions on shapes worked out by hand."""

import math

import pytest

from benchmark.counts import (conv_bn_act, decoder_infer, decoder_train_bwd,
                              decoder_train_fwd, peaks, tacotron2, vocoders)
from benchmark.harness import registry
from benchmark.harness.env import BENCH

CFG = registry.load_json(BENCH / "configs" / "tacotron2-hifigan.json")
M = CFG["model"]


def test_lstm():
    # 4 gates of 3 units, each a dot product over 2 inputs + 3 hidden
    assert tacotron2.lstm(2, 3) == 2 * 4 * 3 * (2 + 3)


def test_decoder_step_at_paper_widths():
    att_lstm = 2 * 4 * 1024 * (256 + 512 + 1024)        # 14,680,064
    query = 2 * 1024 * 128
    per_pos = 2 * 2 * 32 * 31 + 2 * 32 * 128 + 2 * 128 + 2 * 512
    dec_lstm = 2 * 4 * 1024 * (1024 + 512 + 1024)       # 20,971,520
    heads = 2 * 81 * 1536
    want = att_lstm + query + 48 * per_pos + dec_lstm + heads
    assert tacotron2.decoder_step(M, 48) == want == 36_807_680


def test_postnet_and_encoder():
    assert tacotron2.postnet_frame(M) == 2 * 5 * (80 * 512 + 3 * 512 * 512
                                                  + 512 * 80)
    assert tacotron2.encoder_token(M) == (3 * 2 * 512 * 512 * 5
                                          + 2 * 2 * 4 * 256 * (512 + 256)
                                          + 2 * 512 * 128)


def test_train_step_is_three_forwards_at_true_lengths():
    one = tacotron2.forward(M, 90, 566)
    assert tacotron2.train_step(M, [90, 90], [566, 566]) == 6 * one
    # about 144 MFLOP a frame at LJSpeech's mean length
    assert 140e6 < tacotron2.train_step(M, [90], [566]) / 566 < 150e6


def test_hifigan_v1_per_frame():
    h = CFG["hifigan"]
    resblocks = sum(252 * c * c * u for c, u in ((256, 8), (128, 64),
                                                 (64, 128), (32, 256)))
    ups = (2 * 512 * 256 * 16 + 2 * 256 * 128 * 16 * 8
           + 2 * 128 * 64 * 4 * 64 + 2 * 64 * 32 * 4 * 128)
    pre_post = 2 * 80 * 512 * 7 + 2 * 32 * 7 * 256
    assert vocoders.hifigan_frame(h) == resblocks + ups + pre_post \
        == 614_105_088


def test_griffinlim_per_frame():
    a = CFG["audio"]
    fft = 2.5 * 1024 * 10
    want = 2 * 513 * 80 * 201 + 121 * fft
    assert vocoders.griffinlim_frame(a, 60) == int(want)


def test_conv_bn_act():
    assert conv_bn_act.ops(20, 3, 4, 5) == 2 * 20 * 3 * 4 * 5
    assert conv_bn_act.nbytes(20, 3, 4, 5, 4) == 4 * (60 + 60 + 4 + 80)
    shapes = conv_bn_act.launches(M, 3000, 9000)
    assert shapes[:3] == [(3000, 512, 512, 5)] * 3
    assert [s[0] for s in shapes[3:]] == [9000] * 5
    assert [s[1:3] for s in shapes[3:]] == [(80, 512), (512, 512),
                                            (512, 512), (512, 512),
                                            (512, 80)]


def test_decoder_kernels_count_each_row_at_its_own_lengths():
    step = tacotron2.decoder_step
    assert decoder_train_fwd.ops(M, [(16, 3), (16, 3)]) == 6 * step(M, 16)
    assert decoder_train_fwd.ops(M, [(16, 3), (8, 2)]) == (3 * step(M, 16)
                                                           + 2 * step(M, 8))
    assert decoder_train_bwd.ops(M, [(16, 3)]) == 3 * step(M, 16)
    assert decoder_infer.ops(M, [(16, 4)]) == 4 * (
        tacotron2.prenet_frame(M) + step(M, 16))
    # the weights alone, read once, in bf16 and fp32; a row adds its own
    w = decoder_train_fwd.step_weights(M)
    assert 18.0e6 < w < 18.2e6
    assert decoder_infer.nbytes(M, [], 4) > 4 * w
    for k in (decoder_train_fwd, decoder_train_bwd):
        one = k.nbytes(M, [(16, 3)], 2)
        assert k.nbytes(M, [(16, 3), (16, 3)], 2) - one == one - 2 * w
        assert k.nbytes(M, [(16, 3)], 2) < k.nbytes(M, [(32, 3)], 2)


@pytest.mark.parametrize("ops,nbytes,prec,want", [
    (989e12, 0, "bfloat16", 1.0),
    (0, 3.35e12, "float32", 1.0),
    (67e12, 6.7e12, "float32", 2.0),
])
def test_least_time(ops, nbytes, prec, want):
    assert math.isclose(peaks.least_time_s(ops, nbytes, prec), want)
