"""Frozen operation and byte counts, pure Python over shapes, and the
card's peaks: the yardstick of the roofline and utilization metrics.
Bytes count each input byte read once and each output byte written
once, whatever an implementation reads again."""
