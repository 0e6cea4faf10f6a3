"""The benchmark's general code: finding a cell's files, the card, timing
and spans, the profiled slice, weights from the seed, the checks, and one
run of a cell."""
