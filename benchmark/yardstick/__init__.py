"""The benchmark's yardstick: the arithmetic of its metrics and of the
comparison that decides `correct`, kept beside the benchmark so that a
change to the program cannot move it."""
