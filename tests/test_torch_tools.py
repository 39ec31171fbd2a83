"""The port's measurement and serving tools against the JAX package's, on
the CPU at small widths: the decode sweeps' calls against ``tacotron2_infer``
and ``synthesize_wav_buckets`` (mels to 1e-3), the training sweep's first
step against ``train_step`` (losses to tests/test_torch_train.py's 1e-5
relative), the profile's kernel classes, the NGC check's report against the
JAX tool's, the reference-corpus export against the JAX tool's,
``tools/load_test.py`` against the port's server, and
``tools/plot_head_to_head.py`` on a log of the port's training loop.
Weights come from JAX (``utils/weights.py``); inputs from numpy seeds."""

import filecmp
import json
import os
import shutil
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tacotron2_tpu import config as jax_config
from tacotron2_tpu.infer import fused as jax_fused
from tacotron2_tpu.models import hifigan as jax_hifigan
from tacotron2_tpu.models import tacotron2_infer_jit, tacotron2_init
from tacotron2_tpu.train import step as jax_step
from tacotron2_tpu.train.checkpoint import save_params_only
from tacotron2_tpu.train.optim import make_optimizer as jax_make_optimizer
from tacotron2_tpu.train.state import TrainState as JaxTrainState
from tacotron2_torch import config as port_config
from tacotron2_torch.dsp import griffinlim as tgl
from tacotron2_torch.infer import fused as port_fused
from tacotron2_torch.infer import server as srv
from tacotron2_torch.models import hifigan as port_hifigan
from tacotron2_torch.models.tacotron2 import Tacotron2
from tacotron2_torch.train.optim import make_optimizer
from tacotron2_torch.train.state import TrainState
from tacotron2_torch.utils.weights import load_jax_params

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
import bench_infer_scaling_torch as infer_tool  # noqa: E402
import bench_train_scaling_torch as train_tool  # noqa: E402
import export_reference_corpus as jax_export  # noqa: E402
import export_reference_corpus_torch as port_export  # noqa: E402
import load_test  # noqa: E402
import plot_head_to_head  # noqa: E402
import profile_train_step_torch as profile_tool  # noqa: E402
import verify_ngc_checkpoint as jax_ngc  # noqa: E402
import verify_ngc_checkpoint_torch as port_ngc  # noqa: E402

CPU = torch.device("cpu")
# n_mels stays 80: the sweeps vocode with the audio config's filterbank
SMALL = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
             decoder_rnn_dim=64, attention_rnn_dim=64, attention_dim=16,
             location_n_filters=4, location_kernel_size=7,
             postnet_embedding_dim=32, prenet_dim=16)
NO_DROPOUT = dict(p_attention_dropout=0.0, p_decoder_dropout=0.0,
                  p_prenet_dropout=0.0, p_postnet_dropout=0.0)
MEL_TOL = 1e-3


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def infer_models():
    """JAX weights at SMALL and the port's model carrying them."""
    jcfg = jax_config.Config(model=jax_config.ModelConfig(**SMALL))
    cfg = port_config.Config(model=port_config.ModelConfig(**SMALL))
    params, state = tacotron2_init(jax.random.PRNGKey(0), jcfg.model)
    model = load_jax_params(Tacotron2(cfg.model), np_tree(params),
                            np_tree(state))
    return params, state, jcfg, model, cfg


@pytest.fixture
def jax_phase(monkeypatch):
    """Hand the port the JAX package's own Griffin-Lim initial phase."""
    def draw(shape, seed, device):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.PRNGKey(seed), tuple(shape), minval=0.0,
            maxval=2.0 * np.pi)))
    monkeypatch.setattr(tgl, "_initial_phase", draw)


# --------------------------------------------------------------------------
# tools/bench_infer_scaling_torch.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("b,stop", [(1, 6), (3, 12)])
def test_mega_run_matches_jax(infer_models, b, stop):
    """One call of the mega sweep at a forced stop against the JAX
    ``tacotron2_infer`` on the same tokens: frame ends exactly, the postnet
    mels over the decoded frames to 1e-3."""
    params, state, jcfg, model, _ = infer_models
    tokens, lengths = infer_tool.mega_tokens(np.random.default_rng(b), b, 16)
    ref, ref_n, ref_ends = tacotron2_infer_jit(
        params, state, jcfg.model, jnp.asarray(tokens), max_steps=12,
        text_lengths=jnp.asarray(lengths), stop_mode="all",
        forced_stop_at=jnp.int32(stop))
    out, n, ends = infer_tool.mega_run(model, tokens, lengths, stop, CPU,
                                       max_steps=12)
    assert int(n) == int(ref_n) == stop
    np.testing.assert_array_equal(ends.numpy(), np.asarray(ref_ends))
    np.testing.assert_allclose(out.mel_postnet[:, :stop].numpy(),
                               np.asarray(ref.mel_postnet)[:, :stop],
                               atol=MEL_TOL, rtol=0)


def test_sweep_mega_records(infer_models):
    """The sweep runs both decoders at each batch and stop, gives each
    point its walls, per-stream numbers and the forced frame ends, leaves
    the model's decoder switch as it was, and reads no device time off
    the card."""
    model = infer_models[3]
    lines = []
    records = infer_tool.sweep_mega(model, CPU, [1, 2], t_enc=16, iters=1,
                                    max_steps=12, stops=(6, 12),
                                    log=lines.append)
    assert [(r["decoder"], r["b"], r["stop"]) for r in records] == [
        (d, b, s) for d in ("megakernel", "step_loop") for b in (1, 2)
        for s in (6, 12)]
    for r in records:
        assert r["frame_ends"] == [r["stop"]] * r["b"]
        assert r["wall_ms"] > 0 and r["device_busy_ms"] is None
        assert r["ms_per_stream"] == pytest.approx(r["wall_ms"] / r["b"])
    assert len(lines) == 8 and all("per-stream RTF" in ln for ln in lines)
    assert model.cfg.decoder_megakernel


def test_buckets_run_matches_jax(infer_models, jax_phase):
    """One call of the buckets sweep against the JAX
    ``synthesize_wav_buckets`` at a forced stop: frame ends and the bucket
    exactly; the decoded mels to 1e-3; the int16 PCM after four
    Griffin-Lim iterations from the JAX package's initial phase to
    tests/test_torch_server.py's limit, 2e-3 of full scale and one LSB
    (the sweep's sixty iterations carry the mels' last digits on: seeded
    weights clip the waveform, and the two part by 203 LSB there)."""
    params, state, jcfg, model, cfg = infer_models
    tokens, lengths = infer_tool.buckets_tokens(n=24)
    ref_pcm, ref_ends = jax_fused.synthesize_wav_buckets(
        params, state, jcfg.model, jcfg.audio, jnp.asarray(tokens),
        jnp.asarray(lengths), None, max_steps=40, gl_iters=4,
        forced_stop_at=jnp.int32(20))
    pcm, ends = infer_tool.buckets_run(model, cfg.audio, tokens, lengths, 20,
                                       CPU, max_steps=40, gl_iters=4)
    np.testing.assert_array_equal(ends, np.asarray(ref_ends))
    assert ends.tolist() == [20] and pcm.shape == np.asarray(ref_pcm).shape
    ref_mel = jax_fused.decode_mel_fused(
        params, state, jcfg.model, jnp.asarray(tokens), jnp.asarray(lengths),
        max_steps=40, forced_stop_at=jnp.int32(20))[0]
    mel = port_fused.decode_mel_fused(model, tokens, lengths, max_steps=40,
                                      forced_stop_at=20, device="cpu")[0]
    np.testing.assert_allclose(mel[:, :20].numpy(),
                               np.asarray(ref_mel)[:, :20], atol=MEL_TOL,
                               rtol=0)
    assert np.abs(pcm.astype(np.int32)
                  - np.asarray(ref_pcm).astype(np.int32)).max() \
        <= 2e-3 * 32767 + 1
    rec = infer_tool.sweep_buckets(model, cfg, CPU, iters=1, stop=20,
                                   max_steps=40, log=lambda _: None)
    assert rec["frames"] == 20 and rec["rtf"] > 0


def test_sweep_sharded_records(infer_models):
    """The sharded sweep over two CPU replicas: the unsharded pipeline,
    then the synthesizer, at each batch (3: the second shard padded), in
    aggregate frames a second."""
    model, cfg = infer_models[3], infer_models[4]
    records = infer_tool.sweep_sharded(model, cfg, ["cpu", "cpu"], [2, 3],
                                       cap=8, iters=1, log=lambda _: None)
    assert [(r["path"], r["b"]) for r in records] == [
        ("unsharded", 2), ("unsharded", 3), ("sharded(2)", 2),
        ("sharded(2)", 3)]
    for r in records:
        assert r["frames_per_s"] == pytest.approx(r["b"] * 8 / r["wall_s"])


def test_infer_tool_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_tool.main(["--sweep", "buckets"])


# --------------------------------------------------------------------------
# tools/bench_train_scaling_torch.py, tools/profile_train_step_torch.py
# --------------------------------------------------------------------------
TRAIN_SMALL = dict(SMALL, n_mels=8, **NO_DROPOUT)


@pytest.mark.parametrize("split", [True, False])
def test_train_first_step_matches_jax(split):
    """The training sweep's first step, on JAX weights and the JAX tool's
    batch from the same seed, against the JAX ``train_step`` with split
    BPTT on and off: every loss term to 1e-5 relative (fp32, dropout
    off)."""
    kw = dict(TRAIN_SMALL, decoder_split_bptt=split)
    train = dict(precision="float32")
    jcfg = jax_config.Config(model=jax_config.ModelConfig(**kw),
                             train=jax_config.TrainConfig(**train))
    cfg = port_config.Config(model=port_config.ModelConfig(**kw),
                             train=port_config.TrainConfig(**train))
    params, state = tacotron2_init(jax.random.PRNGKey(2), jcfg.model)
    # before the JAX step, which donates its state's buffers
    model = load_jax_params(Tacotron2(cfg.model), np_tree(params),
                            np_tree(state))
    jtx = jax_make_optimizer(jcfg.train)
    jstate = JaxTrainState(params=params, model_state=state,
                           opt_state=jtx.init(params), step=jnp.int32(0),
                           loss_step=jnp.int32(0),
                           rng=jax.random.PRNGKey(1))
    batch = train_tool.make_batch(np.random.default_rng(0), 2, 12, 16, 8)
    _, ref, _ = jax_step.train_step(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, cfg=jcfg,
        tx=jtx, use_postnet=True,
        sigma_warmup_steps=jcfg.guided_attention.sigma_warmup_steps)
    tstate = TrainState(model=model,
                        opt_state=make_optimizer(cfg.train).init(model),
                        step=0, loss_step=0, generator=torch.Generator())
    rec = train_tool.measure(split, 2, CPU, t_enc=12, t_dec=16, iters=1,
                             cfg=cfg, state=tstate,
                             rng=np.random.default_rng(0),
                             log=lambda _: None)
    assert rec["split"] == split and rec["ms_per_step"] > 0
    for name in ref._fields:
        np.testing.assert_allclose(rec["first_losses"][name],
                                   float(getattr(ref, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_train_tool_reports_failed_and_goes_on(monkeypatch):
    """A configuration that raises prints FAILED, and the sweep goes on to
    the next."""
    def measure(split, b, *args, **kwargs):
        if split:
            raise MemoryError("out of memory")
        return dict(split=split, b=b)

    monkeypatch.setattr(train_tool, "measure", measure)
    lines = []
    records = train_tool.main(["4,8", "--device", "cpu"], log=lines.append)
    failed = [ln for ln in lines if "FAILED" in ln]
    assert failed == [f"  split=True B={b}: FAILED MemoryError: out of "
                      f"memory" for b in (4, 8)]
    assert [r.get("failed") is None for r in records] == [True, False] * 2


KERNEL_NAMES = [
    ("void attention_tail_kernel(TailArgs)", "attention_tail"),
    ("attention_tail_wide_kernel(TailArgs)", "attention_tail"),
    ("decoder_infer_kernel(DecoderArgs)", "decoder_infer_mega"),
    ("decoder_train_fwd_kernel(TrainFwdArgs)", "decoder_fwd_train_mega"),
    ("decoder_train_bwd_kernel(TrainBwdArgs)", "decoder_bwd_chain_mega"),
    ("void conv_bn_act_wgmma_kernel<64, true>(CUtensorMap, ConvArgs)",
     "conv_bn_act"),
    ("conv_bn_act_fma_kernel(ConvArgs)", "conv_bn_act"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "gemm"),
    ("nvjet_tst_128x64_64x8_1x2_h_bz_TNN", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_32x6>",
     "gemm"),
    ("void splitKreduce_kernel<32, 16, int, float, float>", "gemm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "cudnn_conv"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_tf32f32", "cudnn_conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>",
     "cudnn_conv"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>", "elementwise/reduction"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
     "elementwise/reduction"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>",
     "elementwise/reduction"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>",
     "elementwise/reduction"),
    ("Memcpy HtoD (Pageable -> Device)", "copy/memset"),
    ("Memset (Device)", "copy/memset"),
    ("void at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)",
     "copy/memset"),
    ("void (anonymous namespace)::lstm_cell_forward<float>", "other"),
]


@pytest.mark.parametrize("name,cls", KERNEL_NAMES)
def test_op_class(name, cls):
    assert profile_tool.op_class(name) == cls


def test_profile_train_step_on_the_cpu():
    """Off the card the profile is of the host ops' self time, classed; no
    hand-written kernel launches on the CPU."""
    cfg = port_config.Config(model=port_config.ModelConfig(**TRAIN_SMALL))
    r = profile_tool.profile_train_step(2, CPU, t_enc=12, t_dec=16, cfg=cfg)
    assert r["device"] == "cpu" and "busy_ms" not in r
    assert set(r["launches"]) == {k for k, _, _ in profile_tool.KERNELS}
    assert not any(r["launches"].values())
    assert r["per_class"]["gemm"] > 0 and np.isfinite(r["loss"])
    assert sum(r["per_class"].values()) == pytest.approx(
        r["host_self_sum_ms"])
    lines = []
    profile_tool.print_report(r, 5, log=lines.append)
    assert any("not traced (CPU run)" in ln for ln in lines)


def test_busy_time_is_the_union_of_intervals():
    events = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0),
              ("d", 21.0, 22.0)]
    assert profile_tool.busy_us(events) == 17.0


# --------------------------------------------------------------------------
# tools/verify_ngc_checkpoint_torch.py
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ngc_files(tmp_path_factory):
    """One seeded generator saved in NGC's layout, weight-normed and plain,
    and the weight-normed file with ``conv_post.bias`` taken out."""
    d = tmp_path_factory.mktemp("ngc")
    gen = port_hifigan.hifigan_init(seed=3)
    files = {}
    for name, wn in (("weight_normed", True), ("plain", False)):
        files[name] = str(d / f"{name}.pt")
        torch.save({"generator": port_hifigan.nvidia_state_dict(gen, wn)},
                   files[name])
    sd = port_hifigan.nvidia_state_dict(gen, True)
    del sd["conv_post.bias"]
    files["missing"] = str(d / "missing.pt")
    torch.save({"generator": {f"module.{k}": v for k, v in sd.items()}},
               files["missing"])
    return files


@pytest.mark.parametrize("layout", ["weight_normed", "plain"])
def test_ngc_report_matches_jax(ngc_files, layout):
    """The port's report on the card's path (here the CPU) against the JAX
    tool's on one file: the same keys, sha256, key count, layout, manifest
    problems (none), parameter count and output shape, both ok; the
    port's waveform within 2e-4 of the JAX ``hifigan_apply``'s."""
    path = ngc_files[layout]
    ref = jax_ngc.verify(path)
    got = port_ngc.verify(path, device="cpu")
    assert set(got) == set(ref)
    for key in ("checkpoint", "sha256", "n_keys", "layout",
                "manifest_problems", "n_params", "ok"):
        assert got[key] == ref[key], key
    assert got["ok"] and got["layout"] == layout
    assert got["forward"]["out_shape"] == ref["forward"]["out_shape"]
    assert got["torch_parity"]["max_abs_delta"] < port_ngc.PARITY_TOL
    sd = {k: v.numpy() for k, v in torch.load(path)["generator"].items()}
    mel = (np.random.default_rng(0).standard_normal((1, 80, 40))
           .astype(np.float32) - 5.0)
    want = np.asarray(jax_hifigan.hifigan_apply(
        jax_hifigan.params_from_nvidia_state_dict(sd), mel))
    wav = port_hifigan.hifigan_apply(
        port_hifigan.params_from_nvidia_state_dict(sd),
        torch.from_numpy(mel)).numpy()
    assert np.abs(wav - want).max() < port_ngc.PARITY_TOL


def test_ngc_missing_key_fails_both(ngc_files):
    """A file without ``conv_post.bias`` (and with a ``module.`` prefix)
    fails both tools with the same problem; the CLI exits 1."""
    ref = jax_ngc.verify(ngc_files["missing"])
    got = port_ngc.verify(ngc_files["missing"], device="cpu")
    assert not got["ok"] and not ref["ok"]
    assert got["manifest_problems"] == ref["manifest_problems"] == [
        "missing conv_post.bias"]
    assert set(got) == set(ref)
    assert port_ngc.main([ngc_files["missing"], "--device", "cpu"]) == 1


def test_ngc_manifest_is_the_architecture(tmp_path):
    """The committed manifest the tool reads is the one both tools'
    ``--write-manifest`` write."""
    with open(port_ngc.MANIFEST) as f:
        committed = json.load(f)
    assert committed == port_ngc.expected_manifest() \
        == json.loads(json.dumps(jax_ngc.expected_manifest()))
    out = tmp_path / "m.json"
    assert port_ngc.main(["--write-manifest", str(out)]) == 0
    with open(out) as f:
        assert json.load(f) == committed


# --------------------------------------------------------------------------
# tools/export_reference_corpus_torch.py
# --------------------------------------------------------------------------
def write_processed(root):
    """A small processed corpus in the layout preprocess writes."""
    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(root, "mels"))
    os.makedirs(os.path.join(root, "text"))
    rows = []
    for i in range(5):
        base = f"LJT-{i:04d}"
        np.save(os.path.join(root, "mels", f"{base}.npy"),
                rng.standard_normal((80, 20 + 7 * i)).astype(np.float32))
        np.save(os.path.join(root, "text", f"{base}.npy"),
                rng.integers(0, 72, 5 + i).astype(np.int32))
        rows.append(f"wavs/{base}.wav,text {i},{20 + 7 * i}")
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("filepath,text,n_frames\n" + "\n".join(rows) + "\n")


@pytest.mark.parametrize("val_count", [0, 2])
def test_export_matches_jax(tmp_path, val_count):
    """The same files byte for byte in the processed and output dirs (the
    CSVs and their split), and equal tensors of the same types."""
    src = tmp_path / "processed"
    write_processed(str(src))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(src, jdir / "processed")
    shutil.copytree(src, pdir / "processed")
    n_ref = jax_export.export(str(jdir / "processed"), str(jdir / "out"),
                              val_count)
    n = port_export.export(str(pdir / "processed"), str(pdir / "out"),
                           val_count, device="cpu")
    assert n == n_ref == 5
    for sub in ("processed", "out"):
        names = sorted(os.listdir(jdir / sub))
        assert names == sorted(os.listdir(pdir / sub))
        for name in names:
            if name.endswith(".csv"):
                assert filecmp.cmp(jdir / sub / name, pdir / sub / name,
                                   shallow=False), name
    csvs = {"metadata.csv"} | ({"metadata_train.csv", "metadata_val.csv"}
                               if val_count else set())
    assert {x for x in os.listdir(pdir / "out") if x.endswith(".csv")} == csvs
    for kind, dtype in (("mels", torch.float32), ("text", torch.int64)):
        names = sorted(os.listdir(jdir / "out" / kind))
        assert names == sorted(os.listdir(pdir / "out" / kind))
        for name in names:
            want = torch.load(jdir / "out" / kind / name)
            got = torch.load(pdir / "out" / kind / name)
            assert got.dtype == want.dtype == dtype
            assert torch.equal(got, want), name


# --------------------------------------------------------------------------
# tools/load_test.py against the port's server
# --------------------------------------------------------------------------
TINY = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
            decoder_rnn_dim=48, prenet_dim=16, attention_rnn_dim=48,
            attention_dim=24, location_n_filters=8, location_kernel_size=15,
            postnet_embedding_dim=24, max_decoder_steps=24)


@pytest.fixture(scope="module")
def batching_url(tmp_path_factory):
    """``serve_torch.py``'s handler on a ``BatchingTTSService`` of a tiny
    checkpoint that the JAX package saved."""
    params, state = tacotron2_init(jax.random.PRNGKey(0),
                                   jax_config.ModelConfig(**TINY))
    path = str(tmp_path_factory.mktemp("srv") / "model")
    save_params_only(path, params, state)
    service = srv.BatchingTTSService(
        path, port_config.Config(model=port_config.ModelConfig(**TINY)),
        griffinlim_iters=4, max_batch=8, batch_window_ms=200.0,
        device="cpu")
    httpd = srv.ThreadingHTTPServer(("127.0.0.1", 0),
                                    srv.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=120)
    service.close(join_timeout=120)
    assert not thread.is_alive()


@pytest.mark.parametrize("concurrency", [1, 4])
def test_load_test_against_the_port(batching_url, concurrency):
    """``load_test.run_level`` gets a 200 and a WAV on every request; at
    concurrency 4 ``/healthz`` shows batches that coalesced."""
    stats = load_test.run_level(batching_url, concurrency, 8, "griffinlim",
                                timeout=120.0)
    assert stats is not None and stats["requests"] == 8
    assert stats["concurrency"] == concurrency
    assert stats["audio_sec_per_wall_sec"] > 0
    assert stats["latency_p50_s"] <= stats["latency_max_s"]
    health = srv_health(batching_url)
    assert health["requests"] >= 8
    if concurrency > 1:
        assert health["max_batch_observed"] > 1


def srv_health(url):
    import urllib.request
    with urllib.request.urlopen(url + "/healthz", timeout=120) as r:
        return json.loads(r.read())


# --------------------------------------------------------------------------
# tools/plot_head_to_head.py on a log of the port's loop
# --------------------------------------------------------------------------
def test_parse_log_reads_the_port_loop(tmp_path):
    """Two epochs of the port's ``train()`` with validation on a small
    corpus: ``parse_log`` reads each epoch's average loss and validation
    mel, gate and entropy from the loop's log."""
    from tacotron2_torch.data.synth_corpus import write_corpus
    from tacotron2_torch.train.loop import train
    meta = write_corpus(str(tmp_path / "corpus"), 4, seed=1, words=(1, 1),
                        audio=port_config.AudioConfig(n_mels=8),
                        device="cpu")[0]
    cfg = port_config.Config(
        model=port_config.ModelConfig(**TRAIN_SMALL),
        train=port_config.TrainConfig(precision="float32", batch_size=2,
                                      save_every_steps=0))
    ckpt = tmp_path / "ckpt"
    train(meta, str(ckpt), cfg=cfg, epochs=2, val_metadata=meta,
          device="cpu")
    curves = plot_head_to_head.parse_log(str(ckpt / "training_log.txt"))
    for key in ("train_loss", "val_mel", "val_gate", "val_entropy"):
        assert sorted(curves[key]) == [1, 2], key
        assert all(np.isfinite(v) for v in curves[key].values())
    with open(ckpt / "training_log.txt") as f:
        text = f.read()
    assert f"Avg Loss: {curves['train_loss'][2]:.6f}" in text
