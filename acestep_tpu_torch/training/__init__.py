"""Training of the PyTorch port; maps to `acestep_tpu/training`.

The flow-matching step (`train_step`), optax's chain in torch (`optim`), the
LoRA / LoKr trainer (`trainer`), the preprocessed dataset reader (`dataset`),
the gradient-sensitivity estimate (`estimate`), the adapters (`lora`), the
presets (`presets`), `dataset.preprocess_audio_to_sample` and the dataset
builder (`dataset_builder`). The training REST API is `service/train_api`.
"""

from acestep_tpu_torch.training.lora import apply_lora, init_lora_params, merge_lora
from acestep_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    flow_matching_loss,
    make_train_step,
    sample_discrete_timesteps,
    sample_timesteps,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "flow_matching_loss",
    "make_train_step",
    "sample_discrete_timesteps",
    "sample_timesteps",
    "apply_lora",
    "init_lora_params",
    "merge_lora",
]
