"""Train-step builders for AllReduceSGD and AllReduceEA."""

from distlearn_tpu_torch.train.trainer import (EATrainState, TrainState,
                                               build_ea_steps, build_eval_step,
                                               build_sgd_step, build_sync_step,
                                               init_ea_state, init_train_state)

__all__ = ["TrainState", "EATrainState", "init_train_state", "init_ea_state",
           "build_sgd_step", "build_sync_step", "build_eval_step",
           "build_ea_steps"]
