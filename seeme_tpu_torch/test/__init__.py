"""The evaluation CLI (`python -m seeme_tpu_torch.test`)."""
