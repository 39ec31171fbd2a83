"""The device's idle share of the window (%) while the program's span ``loss``
was the innermost program span in flight:
``train/loss.py::tacotron2_loss``."""

from benchmark.harness.program_spans import idle_share


def read(session, driver):
    return idle_share(session, "loss")
