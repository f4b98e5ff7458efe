"""``python -m paddle_tpu_torch.distributed.launch``: the launcher."""
