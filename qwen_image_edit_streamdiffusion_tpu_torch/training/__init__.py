"""Training on the port: LoRA fine-tuning of the MMDiT (``lora_train``)."""
