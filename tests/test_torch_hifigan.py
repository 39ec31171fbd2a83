"""The port's HiFi-GAN generator against the JAX package's (CPU).

One JAX generator from ``hifigan_init(PRNGKey(0))``, bridged into the
port's module (``utils/weights.py::load_jax_hifigan_params``); mels from a
numpy seed go to both.  Limits: fp32 2e-4 (the JAX package's own limit
against an independent PyTorch generator, ``tests/test_hifigan.py``;
observed ~5e-8); the chunked generator against the whole one 2e-5 (the
same windows, convolutions of other lengths); bf16 0.05 on a tanh-bounded
signal (the JAX package's limit for its bf16 cast).  The card's generator
against the CPU's is held in ``chip_smoke.py`` (phase 17).
"""

import numpy as np
import pytest

import jax
import torch

from tacotron2_tpu.models import hifigan as jh
from tacotron2_tpu.models.tacotron2 import (cast_params_bf16 as
                                            jax_cast_params_bf16)
from tacotron2_torch.infer.vocode import load_vocoder
from tacotron2_torch.models import hifigan as th
from tacotron2_torch.utils.weights import (export_jax_hifigan_params,
                                           load_jax_hifigan_params)

TOL, CHUNK_TOL, BF16_TOL = 2e-4, 2e-5, 0.05


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def shared():
    """(JAX params as numpy, the port's generator holding them)."""
    params = np_tree(jh.hifigan_init(jax.random.PRNGKey(0)))
    return params, load_jax_hifigan_params(th.HiFiGAN(), params)


def mel_input(b, t, seed, offset=0.0):
    return (np.random.default_rng(seed).standard_normal((b, 80, t))
            .astype(np.float32) + offset)


def test_constants_match():
    for name in ("LRELU_SLOPE", "UPSAMPLE_RATES", "UPSAMPLE_KERNELS",
                 "UPSAMPLE_INITIAL_CHANNEL", "RESBLOCK_KERNELS",
                 "RESBLOCK_DILATIONS", "TOTAL_UPSAMPLE", "RECEPTIVE_FRAMES"):
        assert getattr(th, name) == getattr(jh, name), name


def test_state_dict_keys_are_nvidia_names():
    keys = set(th.HiFiGAN().state_dict())
    assert {"conv_pre.weight", "ups.3.bias", "resblocks.11.convs1.2.weight",
            "resblocks.0.convs2.0.bias", "conv_post.weight"} <= keys
    assert len(keys) == 2 * (2 + 4 + 12 * 6)


def test_matches_jax_fp32(shared):
    params, model = shared
    mel = mel_input(1, 11, seed=1)
    ref = np.asarray(jh.hifigan_apply(params, mel))
    got = th.hifigan_apply(model, torch.from_numpy(mel))
    assert got.dtype == torch.float32 and got.shape == (1, 11 * 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    assert float(got.abs().max()) <= 1.0
    # the module's forward is the same function
    assert torch.equal(model(torch.from_numpy(mel)), got)


def test_chunked_matches_full(shared):
    _, model = shared
    mel = torch.from_numpy(mel_input(2, 100, seed=2, offset=-5.0))
    full = th.hifigan_apply(model, mel)
    # chunk not dividing T, several chunks, clamped last window
    chunked = th.hifigan_apply_chunked(model, mel, chunk=24)
    assert chunked.shape == full.shape == (2, 100 * 256)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(),
                               atol=CHUNK_TOL, rtol=0)
    # a short input is one window
    short = mel[:, :, :30]
    assert torch.equal(th.hifigan_apply_chunked(model, short, chunk=64),
                       th.hifigan_apply(model, short))
    with pytest.raises(ValueError, match="receptive radius"):
        th.hifigan_apply_chunked(model, mel, chunk=24, overlap=15)


def test_bf16_close_to_jax_bf16(shared):
    params, model = shared
    mel = mel_input(1, 9, seed=3, offset=-5.0)
    ref = np.asarray(jh.hifigan_apply(jax_cast_params_bf16(params), mel))
    got = th.hifigan_apply(th.cast_hifigan_bf16(model), torch.from_numpy(mel))
    assert got.dtype == torch.float32
    assert model.conv_pre.weight.dtype == torch.float32   # a copy was cast
    np.testing.assert_allclose(got.numpy(), ref, atol=BF16_TOL, rtol=0)
    fp32 = th.hifigan_apply(model, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got.numpy(), fp32, atol=BF16_TOL, rtol=0)


def test_weight_bridge_round_trip_and_layout(shared):
    params, model = shared
    back = export_jax_hifigan_params(model)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    # the port's state dict is NVIDIA's layout: the JAX converter, which
    # flips and transposes the transposed convs, gives the JAX params back
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           np_tree(jh.params_from_nvidia_state_dict(sd)),
                           params)


def test_init_draws_the_jax_distribution():
    model = th.hifigan_init(seed=5)
    again = th.hifigan_init(seed=5)
    for (name, p), q in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(p, q), name
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            bound = (m.in_channels * m.kernel_size[0]) ** -0.5
            for p in (m.weight.detach(), m.bias.detach()):
                assert float(p.abs().max()) <= bound, name
                # uniform on [-bound, bound]: the largest draw is close
                if p.numel() >= 256:
                    assert float(p.abs().max()) > 0.9 * bound, name


def test_weight_norm_resolution(shared):
    params, model = shared
    sd = th.nvidia_state_dict(model)
    assert "ups.0.weight_g" in sd and "ups.0.weight" not in sd
    # the split is torch's own weight_norm at dim 0
    conv = th.params_from_nvidia_state_dict(
        th.nvidia_state_dict(model, weight_norm=False)).ups[0]
    torch.nn.utils.parametrizations.weight_norm(conv)
    orig = conv.parametrizations.weight
    np.testing.assert_allclose(sd["ups.0.weight_g"].numpy(),
                               orig.original0.detach().numpy(),
                               atol=1e-7, rtol=0)
    np.testing.assert_array_equal(sd["ups.0.weight_v"].numpy(),
                                  orig.original1.detach().numpy())
    got = th.params_from_nvidia_state_dict(sd)
    ref = jh.params_from_nvidia_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    # the same resolution arithmetic on the same numbers
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, atol=1e-7, rtol=0),
        export_jax_hifigan_params(got), np_tree(ref))
    mel = torch.from_numpy(mel_input(1, 5, seed=4))
    np.testing.assert_allclose(th.hifigan_apply(got, mel).numpy(),
                               th.hifigan_apply(model, mel).numpy(),
                               atol=TOL, rtol=0)


def test_ngc_file_round_trip(shared, tmp_path, monkeypatch):
    """A ``torch.save``d NGC-layout file ({"generator": weight-normed state
    dict}) through ``load_hifigan_params`` and ``load_vocoder``, against
    the JAX package's loader of the same file; the argument, then
    $HIFIGAN_CHECKPOINT, then ./hifigan_checkpoint.pt."""
    _, model = shared
    path = tmp_path / "hifigan_gen.pt"
    torch.save({"generator": th.nvidia_state_dict(model)}, str(path))
    mel = mel_input(1, 6, seed=5)
    ref = np.asarray(jh.hifigan_apply(jh.load_hifigan_params(str(path)),
                                      mel))
    got = th.load_hifigan_params(str(path), device="cpu")
    assert isinstance(got, th.HiFiGAN)
    np.testing.assert_allclose(
        th.hifigan_apply(got, torch.from_numpy(mel)).numpy(), ref,
        atol=TOL, rtol=0)
    voc = load_vocoder("hifigan", str(path), device="cpu")
    np.testing.assert_allclose(voc(torch.from_numpy(mel)).numpy(), ref,
                               atol=TOL, rtol=0)

    monkeypatch.setenv("HIFIGAN_CHECKPOINT", str(path))
    monkeypatch.chdir(tmp_path)
    assert torch.equal(th.load_hifigan_params(device="cpu").ups[0].weight,
                       got.ups[0].weight)
    monkeypatch.delenv("HIFIGAN_CHECKPOINT")
    torch.save({"generator": model.state_dict()},
               str(tmp_path / "hifigan_checkpoint.pt"))
    assert torch.equal(th.load_hifigan_params(device="cpu").conv_pre.bias,
                       model.conv_pre.bias)


def test_vocoder_chunk_frames_and_bf16(shared, tmp_path):
    _, model = shared
    path = str(tmp_path / "plain.pt")
    torch.save({"generator": model.state_dict()}, path)
    mel = torch.from_numpy(mel_input(1, 90, seed=6, offset=-5.0))
    full = load_vocoder("hifigan", path, device="cpu")(mel)
    chunked = load_vocoder("hifigan", path, chunk_frames=24,
                           device="cpu")(mel)
    assert torch.is_tensor(full) and full.dtype == torch.float32
    assert chunked.shape == full.shape == (1, 90 * 256)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(),
                               atol=CHUNK_TOL, rtol=0)
    half = load_vocoder("hifigan", path, bf16=True, device="cpu")(mel)
    assert half.dtype == torch.float32
    np.testing.assert_allclose(half.numpy(), full.numpy(), atol=BF16_TOL,
                               rtol=0)
    with pytest.raises(ValueError, match="chunk_frames"):
        load_vocoder("hifigan", path, chunk_frames=0, device="cpu")


def test_missing_checkpoint_file_raises(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="HiFi-GAN checkpoint"):
        th.load_hifigan_params("/nonexistent/ckpt.pt", device="cpu")
    monkeypatch.delenv("HIFIGAN_CHECKPOINT", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="hifigan_checkpoint.pt"):
        load_vocoder("hifigan", device="cpu")
