"""The vocoder's device milliseconds per second of audio it vocoded:
the device's busy time inside the device intervals of the program's
``vocoder`` spans (HiFi-GAN, every kernel of it, or Griffin-Lim) over the
audio of the frames the program counts into them (``vocoder.frames``),
padding included."""

from benchmark.harness.program_spans import counter, device_busy_s


def read(session, driver):
    busy = device_busy_s(session, "vocoder")
    frames = counter("vocoder.frames")
    if busy is None or frames <= 0:
        return None
    a = session.cell.config["audio"]
    return 1000.0 * busy / (frames * a["hop_length"] / a["sampling_rate"])
