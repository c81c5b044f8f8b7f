"""Training substrate of the port: AdamW, schedules, the train step."""
from .optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .train_step import TrainConfig, make_train_step, train_shardings  # noqa: F401
