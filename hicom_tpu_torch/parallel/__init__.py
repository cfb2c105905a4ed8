"""Placement across memories and devices (port of ``hicom_tpu/parallel``): the mesh
and sharded training, sequence-parallel encoding and prefill, and the pipeline."""

from .mesh import MESH_AXES, create_mesh  # noqa: F401
from .pipeline import create_pp_mesh, pipeline_prefill  # noqa: F401
