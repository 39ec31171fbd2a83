"""The port's HTTP server and its services against the JAX package's
(CPU, real sockets on 127.0.0.1).

The tiny config of ``tests/test_server.py``, saved once as an Orbax
checkpoint by the JAX package and loaded by both packages' services from
the same directory.  Behaviour is held as ``tests/test_server.py`` pins it
for the JAX server: routes and status codes, micro-batching, close,
backpressure and timeouts, streaming; and the port's WAV against the JAX
service's.  Every thread join and HTTP call has its own timeout.

Limits.  The WAV against the JAX service's: 2e-3 of the peak after four
Griffin-Lim iterations on the JAX package's own initial phase
(``tests/test_torch_synth.py``), plus one LSB for the 16-bit rounding.
Streamed HiFi-GAN against one-shot HiFi-GAN of the same mel: one LSB (the
same convolutions on windows of other lengths).
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

import jax
import torch

from tacotron2_tpu.config import Config as JaxConfig
from tacotron2_tpu.config import ModelConfig as JaxModelConfig
from tacotron2_tpu.infer.server import TTSService as JaxTTSService
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_tpu.train.checkpoint import save_params_only
from tacotron2_torch.config import Config, ModelConfig
from tacotron2_torch.dsp import griffinlim as tgl
from tacotron2_torch.infer import server as srv
from tacotron2_torch.infer.streaming import stream_mels
from tacotron2_torch.infer.vocode import GriffinLim, vocode_array, vocode_mel
from tacotron2_torch.models import hifigan

TINY = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
            decoder_rnn_dim=48, prenet_dim=16, attention_rnn_dim=48,
            attention_dim=24, location_n_filters=8, location_kernel_size=15,
            postnet_embedding_dim=24, max_decoder_steps=24)
WAV_TOL = 2e-3
HTTP_S = 120            # each HTTP call
JOIN_S = 120            # each thread join


def tiny_cfg() -> Config:
    return Config(model=ModelConfig(**TINY))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    params, state = tacotron2_init(jax.random.PRNGKey(0),
                                   JaxModelConfig(**TINY))
    path = str(tmp_path_factory.mktemp("srv") / "model")
    save_params_only(path, params, state)
    return path


@pytest.fixture
def jax_phase(monkeypatch):
    """Hand the port the JAX package's own initial-phase draw."""
    def draw(shape, seed, device):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.PRNGKey(seed), tuple(shape), minval=0.0,
            maxval=2.0 * np.pi)))
    monkeypatch.setattr(tgl, "_initial_phase", draw)


def start_http(service):
    httpd = srv.ThreadingHTTPServer(("127.0.0.1", 0),
                                    srv.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop_http(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=JOIN_S)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def server(ckpt):
    service = srv.TTSService(ckpt, tiny_cfg(), griffinlim_iters=4,
                             device="cpu")
    httpd, thread, url = start_http(service)
    yield url
    stop_http(httpd, thread)


@pytest.fixture(scope="module")
def batching_service(ckpt):
    # a generous window, so that concurrent test requests land in one
    # batch whatever the scheduling
    service = srv.BatchingTTSService(ckpt, tiny_cfg(), griffinlim_iters=4,
                                     max_batch=8, batch_window_ms=1000.0,
                                     device="cpu")
    yield service
    service.close(join_timeout=JOIN_S)
    assert not service._worker.is_alive()


def post(url, path, payload=None, data=None):
    req = urllib.request.Request(
        url + path, data=data if data is not None else
        json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_S) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=HTTP_S) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wav_samples(body: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == 22050 and w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def run_threads(fn, args_list):
    threads = [threading.Thread(target=fn, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()


# ---------------------------------------------------------------------------
# routes and status codes
# ---------------------------------------------------------------------------
def test_healthz(server):
    status, body = get(server, "/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"


def test_synthesize_returns_wav(server):
    status, headers, body = post(server, "/synthesize",
                                 {"text": "Hello world."})
    assert status == 200 and headers.get("Content-Type") == "audio/wav"
    pcm = wav_samples(body)
    # the gate of random weights never fires: max_decoder_steps frames
    assert pcm.shape == (24 * 256,)


def test_bad_requests_are_400(server):
    status, _, body = post(server, "/synthesize", {})
    assert status == 400 and b"text" in body
    assert post(server, "/synthesize",
                {"text": "hi", "vocoder": "wavenet"})[0] == 400
    assert post(server, "/synthesize", data=b"{not json")[0] == 400
    assert post(server, "/synthesize",
                {"text": "hi", "speaker_id": "0"})[0] == 400
    assert post(server, "/synthesize", {"text": "hi", "speaker_id": 3})[0] \
        == 400
    assert post(server, "/synthesize_streaming",
                {"text": "x", "chunk_frames": 1})[0] == 400


def test_unknown_route_is_404(server):
    assert get(server, "/nope")[0] == 404
    assert post(server, "/nope", {"text": "hi"})[0] == 404


def test_hifigan_without_checkpoint_is_503(server, monkeypatch, tmp_path):
    monkeypatch.delenv("HIFIGAN_CHECKPOINT", raising=False)
    monkeypatch.chdir(tmp_path)    # no stray hifigan_checkpoint.pt
    status, _, body = post(server, "/synthesize",
                           {"text": "hi", "vocoder": "hifigan"})
    assert status == 503 and b"HiFi-GAN checkpoint" in body
    assert post(server, "/synthesize_streaming",
                {"text": "hi", "vocoder": "hifigan"})[0] == 503


def test_wav_matches_jax_service(ckpt, jax_phase):
    """The port's service against the JAX package's on the same checkpoint
    directory: the WAV's samples, both vocoded by Griffin-Lim."""
    cfg = tiny_cfg()
    jax_svc = JaxTTSService(ckpt, JaxConfig(model=JaxModelConfig(**TINY)),
                            griffinlim_iters=4)
    svc = srv.TTSService(ckpt, cfg, griffinlim_iters=4, device="cpu")
    for text in ("Hello world.", "A longer sentence, of more tokens."):
        ref = wav_samples(jax_svc.synthesize(text)).astype(np.int32)
        got = wav_samples(svc.synthesize(text)).astype(np.int32)
        assert got.shape == ref.shape
        diff = np.abs(got - ref).max()
        assert diff <= 1 + WAV_TOL * np.abs(ref).max(), diff
    assert svc.request_count == 2 and svc.stats == {}


# ---------------------------------------------------------------------------
# micro-batching
# ---------------------------------------------------------------------------
def test_concurrent_requests_coalesce(batching_service):
    svc = batching_service
    texts = ["Hello world.", "A second sentence.", "Third one here.",
             "And a fourth."]
    results, errors = [None] * len(texts), []

    def call(i):
        try:
            results[i] = svc.synthesize(texts[i])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    run_threads(call, [(i,) for i in range(len(texts))])
    assert not errors
    for wav in results:
        assert wav_samples(wav).shape == (24 * 256,)
    stats = svc.stats
    assert stats["max_batch_observed"] >= 2
    assert stats["batched_requests"] >= 2
    assert stats["batch_retries"] == 0
    assert svc.request_count >= len(texts)


def test_single_request_and_bad_speaker(batching_service):
    assert wav_samples(batching_service.synthesize("Solo request.")).size
    before = batching_service.stats["batches"]
    with pytest.raises(ValueError):
        batching_service.synthesize("hi", speaker_id=3)
    # rejected in the request thread, never reached the device worker
    assert batching_service.stats["batches"] == before


def test_batch_padded_to_power_of_two_by_repeating_last(batching_service,
                                                        monkeypatch):
    """Three requests decode as a batch of four, the last text repeated,
    and each vocoder group is vocoded in one call."""
    svc = batching_service
    seen, calls = [], []
    orig = srv.synthesize_mels

    def spy(model, texts, **kw):
        seen.append((list(texts), kw.get("speaker_id")))
        return orig(model, texts, **kw)

    def fake_hifigan(mel_bct):
        calls.append(tuple(mel_bct.shape))
        return torch.zeros(mel_bct.shape[0], mel_bct.shape[2] * 256)

    monkeypatch.setattr(srv, "synthesize_mels", spy)
    monkeypatch.setattr(svc, "_hifigan_vocoder", fake_hifigan)
    batch = [srv._Pending(t, v, None) for t, v in
             (("One.", "griffinlim"), ("Two two.", "hifigan"),
              ("Three.", "hifigan"))]
    svc._process(batch)
    assert seen == [(["One.", "Two two.", "Three.", "Three."],
                     [None] * 4)]
    assert calls == [(2, 80, 128)]
    assert all(item.error is None and item.wav for item in batch)
    assert not np.any(wav_samples(batch[1].wav))
    assert svc._bucket_size(5) == 8 and svc._bucket_size(9) == 8


def test_failing_batch_is_retried_per_item(batching_service, monkeypatch):
    svc = batching_service
    orig = srv.synthesize_mels

    def fail_batches(model, texts, **kw):
        if len(texts) > 1:
            raise RuntimeError("batch failed")
        if texts[0] == "bad":
            raise RuntimeError("bad request")
        return orig(model, texts, **kw)

    monkeypatch.setattr(srv, "synthesize_mels", fail_batches)
    batch = [srv._Pending("good", "griffinlim", None),
             srv._Pending("bad", "griffinlim", None)]
    retries = svc.stats["batch_retries"]
    svc._process(batch)
    assert batch[0].wav and batch[0].error is None
    assert batch[1].wav is None and "bad request" in str(batch[1].error)
    assert svc.stats["batch_retries"] == retries + 1


def test_http_roundtrip_with_batching(batching_service):
    httpd, thread, url = start_http(batching_service)
    try:
        statuses = []

        def call(text):
            status, headers, body = post(url, "/synthesize", {"text": text})
            statuses.append((status, headers.get("Content-Type"), len(body)))

        run_threads(call, [(f"Request {i}.",) for i in range(3)])
        assert statuses == [(200, "audio/wav", 44 + 2 * 24 * 256)] * 3
        status, body = get(url, "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok"
        assert health["batches"] >= 1 and health["max_batch"] == 8
    finally:
        stop_http(httpd, thread)


def test_close_rejects_new_requests(ckpt):
    svc = srv.BatchingTTSService(ckpt, tiny_cfg(), griffinlim_iters=2,
                                 max_batch=2, device="cpu")
    assert svc.synthesize("Before close.")
    svc.close(join_timeout=JOIN_S)
    assert not svc._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        svc.synthesize("After close.")


def test_close_mid_batch_leaves_sentinel_for_worker(ckpt):
    """close() whose join times out inside a batch leaves the shutdown
    sentinel to the worker, which exits once the batch is done."""
    svc = srv.BatchingTTSService(ckpt, tiny_cfg(), griffinlim_iters=2,
                                 max_batch=2, device="cpu")
    started, release = threading.Event(), threading.Event()
    orig = svc._process

    def slow(batch):
        started.set()
        release.wait(timeout=60)
        return orig(batch)

    svc._process = slow
    t = threading.Thread(target=lambda: svc.synthesize("Hold it open."))
    t.start()
    assert started.wait(timeout=60)
    svc.close(join_timeout=0.2)        # times out mid-batch
    assert svc._worker.is_alive()      # still finishing the batch
    release.set()
    svc._worker.join(timeout=JOIN_S)
    assert not svc._worker.is_alive()  # took the kept sentinel
    t.join(timeout=JOIN_S)
    assert not t.is_alive()            # the request completed


def test_constructor_rejects_bad_limits(ckpt):
    for kw in (dict(max_batch=0), dict(max_queue=0),
               dict(request_timeout_s=0.0)):
        with pytest.raises(ValueError):
            srv.BatchingTTSService(ckpt, tiny_cfg(), device="cpu", **kw)


def test_cuda_service_without_card_raises(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        srv.TTSService(ckpt, tiny_cfg())


# ---------------------------------------------------------------------------
# backpressure and timeouts
# ---------------------------------------------------------------------------
class BlockedWorker:
    """Holds the batching worker inside _process until released."""

    def __init__(self, svc):
        self.svc = svc
        self.started = threading.Event()
        self.release = threading.Event()
        self._orig = svc._process

    def __enter__(self):
        def slow(batch):
            self.started.set()
            self.release.wait(timeout=60)
            return self._orig(batch)
        self.svc._process = slow
        return self

    def __exit__(self, *exc):
        self.release.set()
        self.svc._process = self._orig


def test_queue_full_sheds_with_overloaded_error(ckpt):
    svc = srv.BatchingTTSService(ckpt, tiny_cfg(), griffinlim_iters=2,
                                 max_batch=1, max_queue=1, device="cpu")
    results, errors = [], []

    def call(text):
        try:
            results.append(svc.synthesize(text))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    try:
        with BlockedWorker(svc) as blk:
            t1 = threading.Thread(target=call, args=("In flight.",))
            t1.start()
            assert blk.started.wait(timeout=60)   # the worker holds it
            t2 = threading.Thread(target=call, args=("Queued.",))
            t2.start()
            deadline = time.monotonic() + 30
            while (svc.stats["queue_depth"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert svc.stats["queue_depth"] == 1
            with pytest.raises(srv.ServiceOverloadedError) as ei:
                svc.synthesize("Shed me.")
            assert ei.value.retry_after_s >= 1.0
            blk.release.set()
            for t in (t1, t2):
                t.join(timeout=JOIN_S)
                assert not t.is_alive()
        assert not errors and len(results) == 2
        assert svc.stats["rejected"] == 1 and svc.stats["queue_depth"] == 0
    finally:
        svc.close(join_timeout=JOIN_S)


def test_request_timeout_cancels_and_frees_slot(ckpt):
    svc = srv.BatchingTTSService(ckpt, tiny_cfg(), griffinlim_iters=2,
                                 max_batch=1, max_queue=4,
                                 request_timeout_s=0.1, device="cpu")
    try:
        with BlockedWorker(svc) as blk:
            def hold():
                try:
                    svc.synthesize("hold")
                except srv.ServiceTimeoutError:
                    pass   # may time out too while the worker is held
            t = threading.Thread(target=hold)
            t.start()
            assert blk.started.wait(timeout=60)
            with pytest.raises(srv.ServiceTimeoutError):
                svc.synthesize("too slow")
            assert svc.stats["timeouts"] >= 1
            blk.release.set()
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
        # the cancelled item is dropped by the worker without a decode
        deadline = time.monotonic() + 30
        while svc.stats["queue_depth"] > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.stats["queue_depth"] == 0
    finally:
        svc.close(join_timeout=JOIN_S)


class FailingService:
    """Stands in for a service whose synthesize raises ``error``."""
    cfg = Config()
    request_count = 0
    stats = {}

    def __init__(self, error):
        self.error = error

    def synthesize(self, *a, **kw):
        raise self.error


@pytest.mark.parametrize("error,status,retry_after", [
    (srv.ServiceOverloadedError("queue full", retry_after_s=2.0), 503, "2"),
    (srv.ServiceTimeoutError("timed out"), 504, None),
    (KeyError("boom"), 500, None)])
def test_http_status_of_service_errors(error, status, retry_after):
    httpd, thread, url = start_http(FailingService(error))
    try:
        got, headers, body = post(url, "/synthesize", {"text": "hi"})
        assert got == status
        assert headers.get("Retry-After") == retry_after
        assert json.loads(body)["error"]
    finally:
        stop_http(httpd, thread)


def test_serve_wires_batching_service_at_max_batch_1(monkeypatch):
    """serve(max_batch=1) routes through BatchingTTSService with the
    backpressure settings and the device, and closes it on interrupt."""
    made = {}

    class FakeService:
        def __init__(self, *a, **kw):
            made.update(kw, args=a, closed=False)

        def close(self):
            made["closed"] = True

    class FakeHTTPServer:
        server_address = ("127.0.0.1", 0)

        def __init__(self, addr, handler):
            made["addr"] = addr

        def serve_forever(self):
            raise KeyboardInterrupt   # return from serve() at once

        def server_close(self):
            made["server_closed"] = True

    monkeypatch.setattr(srv, "BatchingTTSService", FakeService)
    monkeypatch.setattr(srv, "ThreadingHTTPServer", FakeHTTPServer)
    srv.serve("unused_ckpt", port=0, max_batch=1, max_queue=7,
              request_timeout_s=1.5, device="cpu")
    assert made["max_batch"] == 1 and made["max_queue"] == 7
    assert made["request_timeout_s"] == 1.5 and made["device"] == "cpu"
    assert made["closed"] and made["server_closed"]


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------
def test_stream_pcm_yields_chunks(batching_service):
    chunks = list(batching_service.stream_pcm("Hello streaming world.",
                                              chunk_frames=8))
    assert len(chunks) >= 2
    pcm = np.frombuffer(b"".join(chunks), dtype="<i2")
    assert pcm.shape == (24 * 256,)


def test_stream_validates_before_yield(batching_service):
    with pytest.raises(ValueError):
        batching_service.stream_pcm("hi", speaker_id=9)


def test_http_streaming_roundtrip(batching_service):
    httpd, thread, url = start_http(batching_service)
    try:
        status, headers, body = post(url, "/synthesize_streaming",
                                     {"text": "Stream me please.",
                                      "chunk_frames": 8})
        assert status == 200
        ctype = headers.get("Content-Type")
        assert ctype.startswith("audio/L16") and "rate=22050" in ctype
        assert len(body) == 2 * 24 * 256
    finally:
        stop_http(httpd, thread)


def full_stream_mel(svc, text, chunk_frames):
    return np.concatenate(list(stream_mels(
        svc.model, text, chunk_frames=chunk_frames, apply_postnet=True,
        device="cpu")))


def test_streamed_hifigan_matches_one_shot(batching_service, monkeypatch):
    """The streamed HiFi-GAN PCM equals the one-shot HiFi-GAN PCM of the
    same mel within one LSB (the receptive-field hold-back)."""
    svc = batching_service
    gen = hifigan.hifigan_init(seed=3)
    monkeypatch.setattr(svc, "_hifigan_vocoder", gen)
    text = "Exact streaming check."
    streamed = np.frombuffer(b"".join(svc.stream_pcm(
        text, vocoder="hifigan", chunk_frames=8)), "<i2").astype(np.int32)
    one_shot = np.frombuffer(srv._pcm16(vocode_array(
        gen, full_stream_mel(svc, text, 8)[None], "cpu")[0]),
        "<i2").astype(np.int32)
    assert streamed.shape == one_shot.shape == (24 * 256,)
    assert np.abs(streamed - one_shot).max() <= 1


def test_streamed_griffinlim_has_one_shot_length(batching_service):
    """Griffin-Lim's phase iteration is chunk-local: the streamed audio is
    an approximation; its length and range hold."""
    svc = batching_service
    text = "Approximate streaming check."
    streamed = np.frombuffer(b"".join(svc.stream_pcm(
        text, vocoder="griffinlim", chunk_frames=8)), "<i2")
    one_shot = vocode_mel(full_stream_mel(svc, text, 8), svc.cfg.audio,
                          GriffinLim(svc.cfg.audio, svc.griffinlim_iters),
                          device="cpu")
    assert streamed.shape == one_shot.shape
    assert np.isfinite(one_shot).all() and np.abs(streamed).max() <= 32767


def test_many_threads_against_one_worker(batching_service):
    """More request threads than cores, with a short switch interval: every
    request is answered and counted once (the counters under their locks)."""
    import sys
    svc = batching_service
    before = (svc.request_count, svc.stats["batches"])
    answers, errors = [], []

    def call(i):
        try:
            answers.append(len(svc.synthesize(f"Request {i}.")))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        run_threads(call, [(i,) for i in range(12)])
    finally:
        sys.setswitchinterval(old)
    assert not errors and answers == [44 + 2 * 24 * 256] * 12
    assert svc.request_count == before[0] + 12
    assert svc.stats["queue_depth"] == 0
    assert before[1] < svc.stats["batches"] <= before[1] + 12


def test_cli_flags():
    """``serve_torch.py`` and ``inference_torch.py`` take ``serve.py``'s
    and ``inference.py``'s flags, plus ``--device`` (default cuda)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import inference_torch
    import serve_torch

    args = serve_torch.parse_args(["--checkpoint", "ck", "--bf16",
                                   "--max_batch", "4", "--n_speakers", "3",
                                   "--request_timeout_s", "2.5"])
    kw = serve_torch.serve_kwargs(args)
    assert kw["device"] == "cuda" and kw["bf16"] and kw["max_batch"] == 4
    assert kw["cfg"].model.n_speakers == 3 and kw["port"] == 8080
    assert kw["request_timeout_s"] == 2.5 and kw["max_queue"] == 64
    assert serve_torch.serve_kwargs(serve_torch.parse_args(
        ["--checkpoint", "ck", "--device", "cpu"]))["cfg"] is None
    with pytest.raises(SystemExit):
        serve_torch.parse_args(["--checkpoint", "ck",
                                "--vocoder_chunk_frames", "0"])
    _, args = inference_torch.parse_args(["Hi.", "--checkpoint", "ck"])
    assert (args.device, args.vocoder, args.output_dir) == (
        "cuda", "hifigan", "generated_audio")
    with pytest.raises(SystemExit):
        inference_torch.main(["--checkpoint", "ck", "--device", "cpu"])
