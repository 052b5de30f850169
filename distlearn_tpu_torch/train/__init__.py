"""Train-step builders for AllReduceSGD and AllReduceEA, and for the LM."""

from distlearn_tpu_torch.train.lm import (LMEAState, LMMixedState,
                                          build_lm_ea_steps,
                                          build_lm_mixed_step,
                                          build_lm_moe_metrics,
                                          build_lm_pp_1f1b_step,
                                          build_lm_pp_step, build_lm_step,
                                          init_lm_ea_state,
                                          init_lm_mixed_state,
                                          lm_local_grads, stack_blocks,
                                          unstack_blocks)
from distlearn_tpu_torch.train.trainer import (EATrainState, TrainState,
                                               build_ea_steps, build_eval_step,
                                               build_sgd_step, build_sync_step,
                                               init_ea_state, init_train_state)

__all__ = ["TrainState", "EATrainState", "init_train_state", "init_ea_state",
           "build_sgd_step", "build_sync_step", "build_eval_step",
           "build_ea_steps", "lm_local_grads", "build_lm_step",
           "build_lm_moe_metrics", "build_lm_pp_step",
           "build_lm_pp_1f1b_step", "stack_blocks", "unstack_blocks",
           "LMMixedState", "init_lm_mixed_state", "build_lm_mixed_step",
           "LMEAState", "init_lm_ea_state", "build_lm_ea_steps"]
