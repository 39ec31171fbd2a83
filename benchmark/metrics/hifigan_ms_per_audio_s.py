"""HiFi-GAN's device milliseconds per second of audio it vocoded: the
traced time of cuDNN's convolution kernels (in eval mode no other cuDNN
convolution runs: the encoder's and postnet's go through kernel #5, the
location convolution inside #2) over the audio of every vocoded frame,
padding included (the fused path vocodes the whole
``max_decoder_steps`` buffer of every row)."""

MARKS = ("cudnn", "fprop", "dgrad", "wgrad", "conv", "winograd", "xmma",
         "implicit_gemm", "nchw", "nhwc")


def read(session, driver):
    cfg = session.cell.config
    if cfg["serve"]["vocoder"] != "hifigan":
        return None
    t = session.trace
    conv_s = sum(e - s for n, s, e in t.events
                 if "conv_bn_act_" not in n
                 and any(m in n.lower() for m in MARKS)) / 1e9
    a = cfg["audio"]
    audio_s = sum(c["tokens"].shape[0] * c["max_steps"] * a["hop_length"]
                  for c in driver.recorder.calls) / a["sampling_rate"]
    if conv_s <= 0 or audio_s <= 0:
        return None
    return 1000.0 * conv_s / audio_s
