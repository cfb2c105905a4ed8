"""Training: the optimizer and freeze matrix, the train step, and checkpoints (port of ``hicom_tpu/train``)."""
