"""The postnet's buffer as a share of the whole buffers (%): the frames
the program's counter ``postnet.frames`` adds on every ``tacotron2_infer``
call (B x the buffer the postnet runs over) over B x ``max_steps`` of the
recorder's calls.  100 where the postnet runs over the whole
``max_decoder_steps`` buffer; below it where the program cuts the buffer
after the decode.  None for a program without the counter."""

from benchmark.harness.program_spans import counter


def read(session, driver):
    frames = counter("postnet.frames")
    whole = sum(c["tokens"].shape[0] * c["max_steps"]
                for c in driver.recorder.calls)
    if frames <= 0 or whole <= 0:
        return None
    return 100.0 * frames / whole
