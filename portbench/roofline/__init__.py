"""The benchmark's own yardstick for roofline shares: the published peaks
of the card (``peaks``) and frozen copies of the byte and operation
counts of the port's kernels (``counts``).  A later change to the
program's own counting functions does not move these; the CPU tests
hold both equal at the cells' shapes so that a divergence shows."""
