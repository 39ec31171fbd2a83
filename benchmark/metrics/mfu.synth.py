"""The synthesis step's share of the card's peak (%): the operations of
the audio delivered (each row to its gate stop: encoder over its tokens,
prenet, decoder step, postnet and vocoder per frame) over the window,
each part at the peak of the type it computes in: the acoustic model in
fp32, HiFi-GAN's convolutions in TF32 (cuDNN's default), Griffin-Lim in
fp32."""

from benchmark.counts import tacotron2, vocoders
from benchmark.counts.peaks import FLOPS


def read(session, driver):
    cfg = session.cell.config
    m = cfg["model"]
    if "hifigan" in cfg and cfg["serve"]["vocoder"] == "hifigan":
        voc, voc_peak = vocoders.hifigan_frame(cfg["hifigan"]), FLOPS["tf32"]
    else:
        voc = vocoders.griffinlim_frame(
            cfg["audio"], cfg["serve"].get("griffinlim_iters", 60))
        voc_peak = FLOPS["float32"]
    least = 0.0
    for c in driver.recorder.calls:
        for tokens, frames in zip(c["lengths"], c["frame_ends"]):
            least += (tacotron2.forward(m, int(tokens), int(frames))
                      / FLOPS["float32"] + int(frames) * voc / voc_peak)
    return 100.0 * least / session.trace.window_s
