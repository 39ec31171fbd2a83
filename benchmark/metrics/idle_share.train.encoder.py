"""The device's idle share of the window (%) while the program's span
``encoder`` was the innermost program span in flight: the encoder in the
forward (``models/encoder.py::encoder_apply``: embedding, three conv +
BatchNorm + ReLU, the BiLSTM as a host loop a frame each way); its backward
lies in ``backward``."""

from benchmark.harness.program_spans import idle_share


def read(session, driver):
    return idle_share(session, "encoder")
