"""The port's quality metrics (``tacotron2_torch/utils/quality.py``)
against the JAX package's (``tacotron2_tpu/utils/quality.py``) on seeded
arrays.  ``tests/test_torch_corpus.py`` holds ``tools/eval_quality_torch.py``
on the trained checkpoint.

Both metric modules are the same numpy code, so every result must be
equal exactly (no tolerance)."""

import numpy as np
import pytest

from tacotron2_tpu.utils import quality as jq
from tacotron2_torch.utils import quality as tq

SHAPES = [(1, 80), (7, 80), (40, 80), (123, 80), (16, 20)]


def _logmel(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2.0 - 6.0).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_coefs", [13, 25])
def test_mel_cepstra_equal(shape, n_coefs):
    x = _logmel(shape, 1)
    np.testing.assert_array_equal(tq.mel_cepstra(x, n_coefs),
                                  jq.mel_cepstra(x, n_coefs))


@pytest.mark.parametrize("t_pred,t_tgt", [(40, 40), (37, 40), (55, 40),
                                          (1, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_mcd_frame_aligned_equal(t_pred, t_tgt, seed):
    pred, tgt = _logmel((t_pred, 80), seed), _logmel((t_tgt, 80), seed + 9)
    got = tq.mcd_frame_aligned(pred, tgt)
    assert got == jq.mcd_frame_aligned(pred, tgt)
    assert tq.mcd_frame_aligned(tgt, tgt) == 0.0 and got > 0.0


@pytest.mark.parametrize("t_pred,t_tgt", [(30, 30), (24, 41), (41, 24),
                                          (1, 12), (2, 2)])
@pytest.mark.parametrize("n_coefs", [13, 20])
def test_mcd_dtw_equal(t_pred, t_tgt, n_coefs):
    pred, tgt = _logmel((t_pred, 80), 3), _logmel((t_tgt, 80), 4)
    assert tq.mcd_dtw(pred, tgt, n_coefs) == jq.mcd_dtw(pred, tgt, n_coefs)


def test_mcd_dtw_of_a_stretched_copy_is_near_zero():
    """Each frame twice: the warp pairs every frame with itself, and only
    the rounding of the expanded squared distance is left."""
    tgt = _logmel((20, 80), 5)
    stretched = np.repeat(tgt, 2, axis=0)
    got = tq.mcd_dtw(stretched, tgt)
    assert got == jq.mcd_dtw(stretched, tgt)
    assert got < 1e-2 < tq.mcd_dtw(_logmel((40, 80), 6), tgt)


@pytest.mark.parametrize("pred,true", [(90, 91), (120, 91), (0, 5), (7, 7)])
def test_gate_timing_error_equal(pred, true):
    assert tq.gate_timing_error(pred, true) == jq.gate_timing_error(
        pred, true) == abs(pred - true)


@pytest.mark.parametrize("t_dec,t_enc,text_len,mel_len,band", [
    (50, 12, None, None, 0.12), (50, 16, 12, 44, 0.12),
    (200, 40, 33, 180, 0.05), (9, 3, None, None, 0.5)])
@pytest.mark.parametrize("kind", ["diagonal", "random"])
def test_alignment_diagonality_equal(t_dec, t_enc, text_len, mel_len, band,
                                     kind):
    rng = np.random.default_rng(t_dec + t_enc)
    if kind == "diagonal":
        pos = np.minimum((np.arange(t_dec) * t_enc) // t_dec, t_enc - 1)
        attn = np.eye(t_enc, dtype=np.float32)[pos]
    else:
        attn = rng.random((t_dec, t_enc)).astype(np.float32)
        attn /= attn.sum(axis=1, keepdims=True)
    got = tq.alignment_diagonality(attn, text_len, mel_len, band)
    assert got == jq.alignment_diagonality(attn, text_len, mel_len, band)
    assert 0.0 <= got <= 1.0
    if kind == "diagonal" and text_len is None:
        assert got == 1.0


@pytest.mark.parametrize("values", [[], [3.0], [2.6, 1.9, 3.8, 2.1, 3.1],
                                    list(np.arange(16) * 0.25)])
def test_summarize_equal(values):
    assert tq.summarize(values) == jq.summarize(values)
