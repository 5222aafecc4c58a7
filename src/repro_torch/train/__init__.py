"""Training of the port: AdamW, the data pipeline, checkpoints, the train
step and the loop (counterpart of ``repro.train``)."""
