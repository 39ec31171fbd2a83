"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the roofline's denominators.  A run reports the card's
``power.limit`` beside them in ``PERF.md``."""

FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_time_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate of ``precision`` and bytes over the memory's rate."""
    return max(ops / FLOPS[precision], nbytes / HBM_BYTES_PER_S)
