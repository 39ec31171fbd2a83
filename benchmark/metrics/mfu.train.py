"""Model FLOPs of the window's train steps at the rows' true lengths
(forward and backward, no recompute), over the window and the bf16 peak:
the step's share of the card's peak (%)."""

from benchmark.counts import tacotron2
from benchmark.counts.peaks import FLOPS


def read(session, driver):
    m = session.cell.config["model"]
    flops = sum(tacotron2.train_step(m, st["text_lengths"], st["mel_lengths"])
                for st in driver.steps)
    return 100.0 * flops / FLOPS["bfloat16"] / session.trace.window_s
