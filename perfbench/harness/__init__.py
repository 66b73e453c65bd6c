"""The general parts of the benchmark: what a cell is, the open-loop load generator,
weights from a seed, the card's energy counter, and the trace reader."""
