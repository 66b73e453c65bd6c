"""Distribution: sharding rules and DTensor placements, the vocab-parallel
embedding and loss, int8 gradient compression, fault injection; the port of
src/repro/distributed/."""
