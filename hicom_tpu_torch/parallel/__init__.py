"""Placement of training state across memories and devices (port of ``hicom_tpu/parallel``)."""
