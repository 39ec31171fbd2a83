"""The device's idle share of the window (%) while the program's span
``backward`` was the innermost program span in flight: autograd over the
step (``train/step.py::_grads``): the encoder BiLSTM's replay and #4 among
it."""

from benchmark.harness.program_spans import idle_share


def read(session, driver):
    return idle_share(session, "backward")
