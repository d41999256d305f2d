"""Operations of the closure's squaring step (B3, ``csrc/closure.cu``).

One step ``A <- A or (A.A > 0)`` on d (w, w) 0/1 matrices is d int8
products of w x w by w x w: ``2 d w^3`` operations, bound by the int8 peak.
A build needs as many steps as change the matrix before its fixed point;
the reference counts them on the run's own inputs, so an early exit cannot
read above 100%."""
from bench.counts import peaks


def squaring_ops(depth: int, width: int) -> int:
    return 2 * depth * width**3


def squaring_bound_s(depth: int, width: int) -> float:
    """Least time of one squaring step at the int8 peak."""
    return squaring_ops(depth, width) / peaks.INT8_OPS_PER_S
