"""The port's checkpoint CLIs against the JAX package's, on the CPU.

``convert_checkpoint_torch.py`` and ``tools/export_checkpoint_torch.py``
against ``convert_checkpoint.py`` and ``tools/export_checkpoint.py`` on
the same seeded weights: a full-width fp32 model (the port's
``init_weights``, with the JAX package's init distributions), saved by
the JAX package as an Orbax params-only checkpoint (its CLIs build the default
``Config()``, so the width is the default one).  Every comparison is bit
for bit.
"""

import os
import runpy
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import convert_checkpoint as jax_convert
import convert_checkpoint_torch as port_convert
from tacotron2_tpu.train.checkpoint import save_params_only
from tacotron2_torch.config import ModelConfig
from tacotron2_torch.infer.synthesize import load_model
from tacotron2_torch.models.tacotron2 import Tacotron2, init_weights
from tacotron2_torch.train import checkpoint as port_ckpt
from tacotron2_torch.train.state import TrainState
from tacotron2_torch.utils.orbax_reader import read_checkpoint
from tacotron2_torch.utils.weight_files import checkpoint_kind, load_weights
from tacotron2_torch.utils.weights import export_jax_params, param_pairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import export_checkpoint_torch as port_export  # noqa: E402


def load_pth(path):
    return torch.load(path, map_location="cpu",
                      weights_only=True)["model_state_dict"]


def assert_state_dicts_equal(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """The seeded Orbax checkpoint and the JAX ``jax2torch`` of it."""
    tmp = tmp_path_factory.mktemp("ckpt_cli")
    params, state = jax.tree_util.tree_map(jnp.asarray, export_jax_params(
        init_weights(Tacotron2(ModelConfig()), 0)))
    orbax = str(tmp / "orbax")
    save_params_only(orbax, params, state)
    jax_pth = str(tmp / "jax2torch.pth")
    jax_convert.jax2torch(orbax, jax_pth)
    return tmp, orbax, jax_pth


def test_port2reference_matches_jax2torch(seeded):
    """From the Orbax checkpoint, from a full checkpoint of the port and
    from a params-only one: the reference-layout ``.pth`` equals the JAX
    ``jax2torch`` output key for key, bit for bit."""
    tmp, orbax, jax_pth = seeded
    ref = load_pth(jax_pth)
    model = load_weights(orbax, Tacotron2(ModelConfig()))
    port_ckpt.save_checkpoint(str(tmp / "full"), TrainState(
        model=model, opt_state={"count": 0, "mu": {}, "nu": {}}, step=0,
        loss_step=0, generator=torch.Generator()), 0, float("inf"))
    port_ckpt.save_params_only(str(tmp / "params"), model)
    for src in (orbax, str(tmp / "full"), str(tmp / "params")):
        out = str(tmp / f"{os.path.basename(src)}.pth")
        port_convert.main(["port2reference", src, out])
        assert_state_dicts_equal(load_pth(out), ref)


def test_reference_round_trip(seeded):
    """The reference's ``.pth`` -> the port's params-only checkpoint ->
    the reference's layout again, bit for bit; the middle is a
    ``weights.pt`` directory whose weights are the reference's."""
    tmp, _, jax_pth = seeded
    mid, back = str(tmp / "from_reference"), str(tmp / "back.pth")
    port_convert.main(["reference2port", jax_pth, mid])
    assert checkpoint_kind(mid) == "params_only"
    port_convert.main(["port2reference", mid, back])
    assert_state_dicts_equal(load_pth(back), load_pth(jax_pth))


def test_help_names_the_jax_directions(capsys):
    with pytest.raises(SystemExit):
        port_convert.main(["--help"])
    text = capsys.readouterr().out
    assert "reference2port" in text and "torch2jax" in text
    assert "port2reference" in text and "jax2torch" in text


def test_export_matches_jax_export(seeded, monkeypatch):
    """``--dtype bfloat16`` from the same checkpoint: every weight's bf16
    bits equal ``tools/export_checkpoint.py``'s artifact read with
    ``utils/orbax_reader.py``, the BatchNorm statistics stay fp32 and equal;
    ``load_model`` reads the export back as fp32."""
    tmp, orbax, _ = seeded
    jax_out, port_out = str(tmp / "jax_export"), str(tmp / "port_export")
    monkeypatch.setattr(sys, "argv", ["export_checkpoint.py", orbax, jax_out,
                                      "--dtype", "bfloat16"])
    runpy.run_path(os.path.join(ROOT, "tools", "export_checkpoint.py"),
                   run_name="__main__")
    port_export.main([orbax, port_out, "--dtype", "bfloat16"])
    assert checkpoint_kind(port_out) == "params_only"
    got = torch.load(os.path.join(port_out, "weights.pt"),
                     weights_only=True)["model"]
    trees = read_checkpoint(jax_out)
    trees = {"params": trees["params"], "state": trees["model_state"]}
    n_bf16 = 0
    for path, key, transpose in param_pairs(ModelConfig()):
        ref = trees[path[0]]
        for k in path[1:]:
            ref = ref[k]
        ref = np.asarray(ref)
        if path[0] == "params":
            assert got[key].dtype == torch.bfloat16, key
            words = got[key].view(torch.int16).numpy().view(np.uint16)
            ref = ref.view(np.uint16).reshape(ref.shape)
            np.testing.assert_array_equal(words, ref.T if transpose else ref,
                                          err_msg=key)
            n_bf16 += 1
        else:
            assert got[key].dtype == torch.float32, key
            np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)
    assert n_bf16 == sum(1 for _ in Tacotron2(ModelConfig()).parameters())
    model = load_model(port_out, device="cpu")
    for name, t in model.state_dict().items():
        assert t.dtype == torch.float32, name
        assert torch.equal(t, got[name].float()), name
