"""Training: AdamW, the train steps (plain, sharded over a device mesh,
int8-compressed data parallel), the synthetic data pipeline, checkpoints and
the elastic trainer; the port of src/repro/training/."""
