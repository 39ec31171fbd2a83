"""The device's idle share of the window (%) while the program's span
``frontend`` was the innermost program span in flight:
``infer/fused.py::synthesize_wav``'s text to token ids on the host, and
their padding."""

from benchmark.harness.program_spans import idle_share


def read(session, driver):
    return idle_share(session, "frontend")
