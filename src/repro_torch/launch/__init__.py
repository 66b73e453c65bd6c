"""Entry points: meshes, the serving and the training launchers; the port of
src/repro/launch/ (its dry-run is not ported yet)."""
