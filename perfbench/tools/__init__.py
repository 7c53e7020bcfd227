"""Measurements made once, by hand, on the card: the seeds, the control
and the planted faults that set a check's limit.  The benchmark's own runs
use none of them."""
