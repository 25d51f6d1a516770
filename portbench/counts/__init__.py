"""The benchmark's yardstick: peaks, operation and byte counts, the union of
device intervals and the kernel classes, frozen here so that a change to
the program cannot move them."""
