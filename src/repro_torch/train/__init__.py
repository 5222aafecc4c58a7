"""Training of the port: AdamW, the data pipeline, checkpoints, the train
step and the loop (counterpart of ``repro.train``)."""
from repro_torch.train.optim import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update)
from repro_torch.train.train_step import (make_serve_step,  # noqa: F401
                                          make_train_step)
