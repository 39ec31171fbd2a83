"""The device's idle share of the window (%) while the program's span
``forward`` was the innermost program span in flight: ``train/step.py``'s
forward less the encoder: the bf16 cast of the masters, the teacher-forced
decoder (#3) and the postnet."""

from benchmark.harness.program_spans import idle_share


def read(session, driver):
    return idle_share(session, "forward")
