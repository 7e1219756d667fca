"""The benchmark's own library: the yardstick that later changes to the
program cannot move (counts, peaks, statistics, the shape sampler, the
trace reduction, the timer, the install cache) and the machinery that
finds a cell's configuration, traffic mix, driver and per-layer metric
readers by name."""
