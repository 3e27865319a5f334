"""LoRA adapters of the PyTorch port; maps to `acestep_tpu/training` (the
trainer, its datasets and steps come with ROADMAP A.9)."""

from acestep_tpu_torch.training.lora import apply_lora, init_lora_params, merge_lora

__all__ = ["apply_lora", "init_lora_params", "merge_lora"]
