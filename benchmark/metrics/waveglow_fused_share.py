"""The share of WaveGlow's WN layers whose elementwise work the program
ran as its two hand-written passes (%): 100 x its counter
``waveglow.wn_layers_fused`` over ``waveglow.wn_layers`` in the window.
None for a program without the counters."""

from benchmark.harness.program_spans import counter


def read(session, driver):
    layers = counter("waveglow.wn_layers")
    if layers <= 0:
        return None
    return 100.0 * counter("waveglow.wn_layers_fused") / layers
