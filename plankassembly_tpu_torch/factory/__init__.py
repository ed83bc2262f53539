"""Offline data factory: shape programs -> three-view line drawings -> info
JSONs (the filesystem contract consumed by the datasets); the port's copy
of `plankassembly_tpu/factory/`, numpy only.

An exact numpy hidden-line removal for axis-aligned box compounds (the
reference uses the OCCT CAD kernel, `dataset/data_utils.py:49-101`), with
the native library's noding and dedupe where it is built, and a procedural
cabinet generator for synthetic data.
"""
from plankassembly_tpu_torch.factory.projection import (
    project_boxes, postprocess_complete, postprocess_visible,
)
from plankassembly_tpu_torch.factory.synthetic import generate_cabinet

__all__ = ["project_boxes", "postprocess_complete", "postprocess_visible",
           "generate_cabinet"]
