"""Training: residual-dynamics regression, excitation signals, checkpoints
and PPO (counterpart of ``dnn_mppi_mpc_tpu/train``)."""

from .checkpoint import load_checkpoint, save_checkpoint, train_state_tree
from .excitation import (
    latin_hypercube,
    multisine_sequence,
    ramp_sequence,
    random_sequence,
    sine_sequence,
    step_sequence,
)
from .rl import (
    ActorCritic,
    PixelActorCritic,
    PPOConfig,
    Transition,
    compute_gae,
    gaussian_log_prob,
    load_flax_actor_critic,
    make_ppo_trainer,
)
from .training import (
    TrainConfig,
    TrainState,
    make_optimizer,
    make_train_step,
    prepare_residual_dataset,
    train_residual_model,
)

__all__ = [
    "ActorCritic",
    "PPOConfig",
    "PixelActorCritic",
    "TrainConfig",
    "TrainState",
    "Transition",
    "compute_gae",
    "gaussian_log_prob",
    "latin_hypercube",
    "load_checkpoint",
    "load_flax_actor_critic",
    "make_optimizer",
    "make_ppo_trainer",
    "make_train_step",
    "multisine_sequence",
    "prepare_residual_dataset",
    "ramp_sequence",
    "random_sequence",
    "save_checkpoint",
    "sine_sequence",
    "step_sequence",
    "train_residual_model",
    "train_state_tree",
]
