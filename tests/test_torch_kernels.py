"""The port's two kernels against their plain versions, without JAX.

The tests marked ``cuda`` launch the Triton ``attention_tail`` and the CUDA
``decoder_infer_mega``; they skip where there is no card.  This file
imports nothing of JAX, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

The other tests run everywhere: the wrappers' routing and checks, the
build's failure without ``nvcc``, and the weight bytes that the decode
kernel's bound is computed from.
"""

import numpy as np
import pytest
import torch

from tacotron2_torch.config import ModelConfig
from tacotron2_torch.models.tacotron2 import (Tacotron2, cast_params_bf16,
                                              init_weights, make_pad_mask)
from tacotron2_torch.ops import _build
from tacotron2_torch.ops.attention_kernel import (attention_tail,
                                                  attention_tail_reference)
from tacotron2_torch.ops.decoder_megakernel import (
    decoder_infer_mega, decoder_infer_mega_reference, weight_bytes)

# every width a multiple of 8, as the decode kernel's vector loads need
SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32)
B, T_ENC, MAX = 2, 12, 14
# One limit per output (mels, gate logits, alignments); alignments here are
# ~1/T_ENC ~ 0.08.  fp32: the same products summed in another order; bf16:
# the kernel's composed location matrix is rounded once, the plain conv
# output per step.
DEC_OUTPUTS = ("mels", "gates", "aligns")
DEC_TOL = {torch.float32: {"mels": 1e-5, "gates": 1e-5, "aligns": 1e-6},
           torch.bfloat16: {"mels": 5e-3, "gates": 5e-3, "aligns": 1e-3}}


def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def tail_inputs(b, t, a, d, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    lens = rng.integers(t // 2, t + 1, b)
    lens[0] = t
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)
    return (f(b, t, a).to(dtype), f(a) * 0.3, f(),
            torch.tensor(1.2).to(device),
            make_pad_mask(torch.from_numpy(lens), t).to(device), f(b, t, d))


def small_decoder(device, dtype=torch.float32, gate_bias=None):
    model = init_weights(Tacotron2(ModelConfig(**SMALL)), seed=0)
    if gate_bias is not None:
        with torch.no_grad():
            model.decoder.gate_layer.bias.fill_(gate_bias)
    if dtype == torch.bfloat16:
        model = cast_params_bf16(model)
    rng = np.random.default_rng(1)
    memory = torch.from_numpy((rng.standard_normal(
        (B, T_ENC, SMALL["encoder_embedding_dim"])) * 0.5).astype(np.float32))
    mask = make_pad_mask(torch.tensor([T_ENC, 9]), T_ENC)
    return model.decoder.to(device), memory.to(device), mask.to(device)


def test_wrappers_reject_other_devices():
    ins = tail_inputs(2, 9, 16, 24, seed=0, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_tail(*ins)
    dec, memory, mask = small_decoder("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        decoder_infer_mega(dec, memory.to("meta"), MAX, 0.5)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["decoder_infer"])


def test_library_path_follows_source():
    path = _build.library_path("decoder_infer")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdecoder_infer-") and path.suffix == ".so"


def test_weight_bytes_full_width():
    """The bytes every decode step reads: ~72.8 MB fp32, ~36.4 MB bf16."""
    cfg = ModelConfig()
    h, e, p = cfg.decoder_rnn_dim, cfg.encoder_embedding_dim, cfg.prenet_dim
    m, a, k = cfg.n_mels, cfg.attention_dim, cfg.location_kernel_size
    matrices = (m * p + p * p + 4 * h * (p + e + h) + 4 * h * (h + e + h)
                + a * h + 2 * k * a + (m + 1) * (h + e))
    fp32_vectors = 4 * h + 4 * h + (m + 1) + a + 2
    model = init_weights(Tacotron2(cfg), seed=0)
    assert weight_bytes(model.decoder) == 4 * (matrices + fp32_vectors)
    bf16 = weight_bytes(cast_params_bf16(model).decoder)
    assert bf16 == 2 * matrices + 4 * fp32_vectors
    assert 36.3e6 < bf16 < 36.5e6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t", [(1, 37), (3, 128), (5, 200)])
def test_triton_tail_matches_plain(dtype, b, t):
    dev = cuda_device()
    ins = tail_inputs(b, t, 128, 512, seed=b + t, device=dev, dtype=dtype)
    before = attention_tail.launches
    got = attention_tail(*ins)
    ref = attention_tail_reference(*ins)
    torch.cuda.synchronize()
    assert attention_tail.launches == before + 1
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("force", [None, 0, 1, 6])
@pytest.mark.parametrize("stop_mode", ["any", "all"])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_matches_plain(dtype, drop, stop_mode, force):
    dec, memory, mask = small_decoder(cuda_device(), dtype)
    args = (dec, memory, MAX, 0.5, drop, mask, stop_mode, force)
    before = decoder_infer_mega.launches
    with torch.no_grad():
        got = decoder_infer_mega(*args)
        ref = decoder_infer_mega_reference(*args)
    torch.cuda.synchronize()
    assert decoder_infer_mega.launches == before + 1
    assert int(got[3]) == int(ref[3])
    assert torch.equal(got[4], ref[4])
    n = int(ref[3])
    for name, g, r in zip(DEC_OUTPUTS, got[:3], ref[:3]):
        torch.testing.assert_close(g[:, :n], r[:, :n],
                                   atol=DEC_TOL[dtype][name], rtol=0,
                                   msg=lambda m: f"{name}: {m}")
        assert torch.equal(g[:, n:], r[:, n:])    # post-stop rows exactly


@pytest.mark.cuda
def test_cuda_decode_natural_gate_fire():
    dec, memory, mask = small_decoder(cuda_device(), gate_bias=5.0)
    with torch.no_grad():
        got = decoder_infer_mega(dec, memory, MAX, 0.5, True, mask, "any")
    assert int(got[3]) == 2       # fires at the first eligible step
    assert got[4].tolist() == [2, 2]
