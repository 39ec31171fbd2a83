"""The port's Orbax reader (no JAX, Orbax or tensorstore) against
tensorstore on the CPU, and ``load_model`` / ``synthesize`` of the port
on a checkpoint directory against the JAX package's.

Every leaf of both committed checkpoints must equal tensorstore's read bit
for bit, in dtype and shape; zstd frames laid end to end decompress and
damaged ones raise; a damaged file raises; a tree that tensorstore writes with small nodes
(interior b-tree nodes, many versions) reads key for key."""

import importlib
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch

from tacotron2_tpu.config import ModelConfig as JaxModelConfig
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_tpu.train.checkpoint import save_params_only
from tacotron2_torch.config import Config, ModelConfig
from tacotron2_torch.dsp.wav import load_audio
from tacotron2_torch.infer import synthesize as synth
from tacotron2_torch.utils import orbax_reader
from tacotron2_torch.utils.orbax_reader import (BFLOAT16, FormatError,
                                                as_float32, read_checkpoint)

jsynth = importlib.import_module("tacotron2_tpu.infer.synthesize")
ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from tools.export_torch_weights import export  # noqa: E402

CKPTS = {name: os.path.join(ROOT, "checkpoints", name)
         for name in ("r4_synth_bf16", "r5_ms_bf16")}
CKPT = CKPTS["r4_synth_bf16"]
SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32)
# the frame the JAX package's synthesize stops at for this sentence on
# r4_synth_bf16 (tests/test_torch_synth.py::SMOKE_FRAME_ENDS), and the
# waveform limit as a share of the peak (tests/test_torch_synth.py)
TEXT, FRAMES, WAV_TOL = "The quick brown fox.", 131, 2e-3


def leaf_paths(path):
    with open(os.path.join(path, "_METADATA"), encoding="utf-8") as f:
        meta = json.load(f)
    return [[k["key"] for k in e["key_metadata"]]
            for e in meta["tree_metadata"].values()]


def get(tree, keys):
    for k in keys:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


@pytest.mark.parametrize("name", list(CKPTS))
def test_every_leaf_matches_tensorstore(name):
    path = CKPTS[name]
    tree = read_checkpoint(path)
    paths = leaf_paths(path)
    assert len(paths) == {"r4_synth_bf16": 78, "r5_ms_bf16": 80}[name]
    for keys in paths:
        ref = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": "file://" + os.path.abspath(path),
            "path": ".".join(keys) + "/"}}, open=True).result().read(
            ).result()
        got = get(tree, keys)
        assert got.shape == ref.shape, keys
        if str(ref.dtype) == "bfloat16":
            assert got.dtype == BFLOAT16, keys
            assert np.array_equal(got.view(np.uint16), ref.view(np.uint16))
            np.testing.assert_array_equal(as_float32(got),
                                          ref.astype(np.float32))
        else:
            assert got.dtype == ref.dtype, keys
            assert got.tobytes() == ref.tobytes(), keys
    # lists where the saved tree had lists
    assert isinstance(tree["params"]["encoder"]["convs"], list)
    assert isinstance(tree["model_state"]["postnet"]["bn"], list)


@pytest.mark.parametrize("name", list(CKPTS))
def test_key_value_store_matches_tensorstore(name):
    """Every key of the store and its value bytes, against tensorstore's
    OCDBT driver."""
    path = os.path.abspath(CKPTS[name])
    store = orbax_reader._Store(path, orbax_reader.decompressor())
    items = store.items()
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + path}
                         ).result()
    keys = kv.list().result()
    assert sorted(keys) == sorted(items)
    for key in keys:
        assert store.value(items[key]) == kv.read(key).result().value, key


def test_small_nodes_and_many_versions(tmp_path):
    """A store tensorstore writes with 300-byte nodes (interior nodes four
    levels deep) over 60 commits (older versions in version-tree nodes),
    with values inline and in data files: the newest version's keys and
    values."""
    base = "file://" + str(tmp_path)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": base, "config": {
        "max_decoded_node_bytes": 300, "max_inline_value_bytes": 16}}
                         ).result()
    want = {}
    for i in range(60):
        key = f"key/{i % 45:03d}/x".encode()
        want[key] = (b"v%d" % i) * (1 + i % 12)
        kv.write(key, want[key]).result()
    store = orbax_reader._Store(str(tmp_path), orbax_reader.decompressor())
    assert store.root_node()[3] > 1
    items = store.items()
    assert sorted(items) == sorted(want)
    for key, value in want.items():
        assert store.value(items[key]) == value


def test_frames_end_to_end():
    """Frames laid end to end, one of them without its content size."""
    zstandard = pytest.importorskip("zstandard")
    one = zstandard.ZstdCompressor().compress(b"tacotron " * 300)
    two = zstandard.ZstdCompressor(write_content_size=False).compress(
        bytes(range(256)) * 40)
    fn = orbax_reader.decompressor()
    assert fn(one + two, 16) == b"tacotron " * 300 + bytes(range(256)) * 40


@pytest.mark.parametrize("damage", ["truncated", "not a frame"])
def test_bad_zstd_raises(damage):
    zstandard = pytest.importorskip("zstandard")
    frame = zstandard.ZstdCompressor().compress(b"tacotron " * 300)
    src = frame[:len(frame) // 2] if damage == "truncated" else b"x" * 64
    with pytest.raises(orbax_reader.FormatError, match="zstd"):
        orbax_reader.decompressor()(src, 16)


def damaged_copy(tmp_path, name, offset, value=None, cut=None):
    """A copy of r4_synth_bf16 (the data files linked, not copied) whose
    file ``name`` has the byte at ``offset`` flipped (or set to
    ``value``), or is cut to ``cut`` bytes."""
    dst = tmp_path / "ckpt"
    shutil.copytree(CKPT, dst, symlinks=True,
                    ignore=lambda d, names: [
                        n for n in names
                        if os.path.getsize(os.path.join(d, n)) > 1 << 20])
    for f in os.listdir(os.path.join(CKPT, "ocdbt.process_0", "d")):
        src = os.path.join(CKPT, "ocdbt.process_0", "d", f)
        if not os.path.exists(dst / "ocdbt.process_0" / "d" / f):
            os.symlink(os.path.abspath(src), dst / "ocdbt.process_0" / "d" / f)
    target = dst / name
    data = bytearray(target.read_bytes())
    if cut is not None:
        data = data[:cut]
    else:
        data[offset] = data[offset] ^ 0xFF if value is None else value
    target.write_bytes(bytes(data))
    return str(dst)


@pytest.mark.parametrize("name,offset,cut,match", [
    ("manifest.ocdbt", 0, None, "magic"),
    ("manifest.ocdbt", 3, None, "magic"),
    ("manifest.ocdbt", 4, None, "header says"),
    ("manifest.ocdbt", None, 60, "header says"),
    ("manifest.ocdbt", 40, None, "CRC32C"),
    ("d/94e331de336d79b2b3fa9fc408e5f8af", 1, None, "magic"),
    ("d/94e331de336d79b2b3fa9fc408e5f8af", 9000, None, "CRC32C"),
])
def test_damaged_files_raise(tmp_path, name, offset, cut, match):
    path = damaged_copy(tmp_path, name, offset, cut=cut)
    with pytest.raises(FormatError, match=match):
        read_checkpoint(path)


def test_reads_a_checkpoint_jax_writes(tmp_path):
    """An fp32 params-only checkpoint that the JAX package's
    ``save_params_only`` writes: every leaf, fp32, bit for bit."""
    params, state = tacotron2_init(jax.random.PRNGKey(2),
                                   JaxModelConfig(**SMALL))
    save_params_only(str(tmp_path / "ckpt"), params, state)
    tree = read_checkpoint(str(tmp_path / "ckpt"))
    for ref_tree, got_tree in ((params, tree["params"]),
                               (state, tree["model_state"])):
        ref, got = (jax.tree_util.tree_leaves(t) for t in (ref_tree,
                                                            got_tree))
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            assert g.dtype == np.float32
            assert np.asarray(r).tobytes() == g.tobytes()


def test_load_model_reads_the_directory(tmp_path):
    """``load_model`` of the directory gives the state_dict that
    ``load_model`` of ``tools/export_torch_weights.py``'s file gives, fp32
    throughout."""
    weights = str(tmp_path / "r4.pt")
    export(CKPT, weights)
    from_file = synth.load_model(weights, device="cpu").state_dict()
    from_dir = synth.load_model(CKPT, device="cpu").state_dict()
    assert set(from_file) == set(from_dir)
    for k, v in from_dir.items():
        assert v.dtype == torch.float32 and torch.equal(v, from_file[k]), k


def test_multi_speaker_checkpoint(tmp_path):
    """r5_ms_bf16 loads with ``n_speakers`` set to its table's rows, as the
    exported file does; without, the error names the rows."""
    cfg = Config(model=ModelConfig(n_speakers=4))
    model = synth.load_model(CKPTS["r5_ms_bf16"], cfg, device="cpu")
    table = read_checkpoint(CKPTS["r5_ms_bf16"])["params"]["speaker"][
        "embedding"]["table"]
    assert table.shape == (4, 64)
    assert torch.equal(model.speaker_embedding.weight,
                       torch.from_numpy(as_float32(table)))
    weights = str(tmp_path / "r5.pt")
    export(CKPTS["r5_ms_bf16"], weights, n_speakers=4)
    ref = synth.load_model(weights, cfg, device="cpu").state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())
    for n in (1, 2):
        with pytest.raises(ValueError, match="4 rows"):
            synth.load_model(CKPTS["r5_ms_bf16"],
                             Config(model=ModelConfig(n_speakers=n)),
                             device="cpu")
    with pytest.raises(ValueError, match="no speaker table"):
        synth.load_model(CKPT, cfg, device="cpu")


def test_synthesize_from_the_directory(tmp_path, monkeypatch):
    """``synthesize(text, checkpoint directory)`` against the JAX
    package's ``synthesize(text, checkpoint)``: the same stop, the same
    audio within the waveform limit."""
    from tacotron2_torch.dsp import griffinlim as tgl

    def draw(shape, seed, device):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.PRNGKey(seed), tuple(shape), minval=0.0,
            maxval=2.0 * np.pi)))

    monkeypatch.setattr(tgl, "_initial_phase", draw)
    ref_path = jsynth.synthesize(TEXT, CKPT, str(tmp_path / "jax"),
                                 griffinlim_iters=2)
    path = synth.synthesize(TEXT, CKPT, str(tmp_path / "port"),
                            griffinlim_iters=2, device="cpu")
    ref, sr_ref = load_audio(ref_path)
    got, sr = load_audio(path)
    assert sr == sr_ref == 22050
    assert len(got) == len(ref) == FRAMES * 256
    peak = float(np.abs(ref).max())
    assert peak > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=WAV_TOL * peak, rtol=0)
