"""3D axis-aligned box operations on tensors (`plankassembly_tpu/ops/
boxes.py`): the reference's `third_party/boxes.py` (a detectron2 Boxes
class extended to 3D) as stateless functions. Boxes are (N, 6) float32
tensors (x1, y1, z1, x2, y2, z2) on the caller's device; array-likes are
taken as CPU tensors.

As in the JAX package, `matched_pairwise_iou` intersects in 3D: the
reference's (`boxes.py:288`, unused there) drops the depth term.
"""
from __future__ import annotations

import torch

from plankassembly_tpu_torch.metrics import pairwise_iou_3d as pairwise_iou  # noqa: F401


def _f32(boxes) -> torch.Tensor:
    return torch.as_tensor(boxes, dtype=torch.float32)


def volume(boxes) -> torch.Tensor:
    """(N,) volumes (`boxes.py:51-60`)."""
    boxes = _f32(boxes)
    return torch.prod(boxes[:, 3:] - boxes[:, :3], dim=-1)


def clip(boxes, box_size) -> torch.Tensor:
    """Clamp coordinates into [0, w] x [0, h] x [0, d] (`boxes.py:62-78`)."""
    boxes = _f32(boxes)
    w, h, d = box_size
    hi = torch.tensor([w, h, d, w, h, d], dtype=torch.float32,
                      device=boxes.device)
    return torch.minimum(boxes.clamp(min=0.0), hi)


def nonempty(boxes, threshold: float = 0.0) -> torch.Tensor:
    """(N,) bool: every side longer than threshold (`boxes.py:80-95`)."""
    boxes = _f32(boxes)
    return (boxes[:, 3:] - boxes[:, :3] > threshold).all(dim=-1)


def inside_box(boxes, box_size, boundary_threshold: int = 0) -> torch.Tensor:
    """(N,) bool: box within the reference box (`boxes.py:127-146`)."""
    w, h, d = box_size
    b = _f32(boxes)
    t = boundary_threshold
    return ((b[:, 0] >= -t) & (b[:, 1] >= -t) & (b[:, 2] >= -t)
            & (b[:, 3] < w + t) & (b[:, 4] < h + t) & (b[:, 5] < d + t))


def get_centers(boxes) -> torch.Tensor:
    """(N, 3) centers (`boxes.py:148-153`)."""
    boxes = _f32(boxes)
    return (boxes[:, :3] + boxes[:, 3:]) / 2.0


def scale(boxes, sx: float, sy: float, sz: float) -> torch.Tensor:
    """Per-axis scaling (`boxes.py:155-161`)."""
    boxes = _f32(boxes)
    return boxes * torch.tensor([sx, sy, sz, sx, sy, sz],
                                dtype=torch.float32, device=boxes.device)


def cat(boxes_list) -> torch.Tensor:
    """Concatenate box arrays (`boxes.py:163-181`); (0, 6) when empty."""
    if not boxes_list:
        return torch.zeros((0, 6), dtype=torch.float32)
    return torch.cat([_f32(b).reshape(-1, 6) for b in boxes_list], dim=0)


def pairwise_intersection(boxes1, boxes2) -> torch.Tensor:
    """(N, M) intersection volumes (`boxes.py:197-215`)."""
    b1, b2 = _f32(boxes1), _f32(boxes2)
    lwh = (torch.minimum(b1[:, None, 3:], b2[None, :, 3:])
           - torch.maximum(b1[:, None, :3], b2[None, :, :3]))
    return torch.prod(lwh.clamp(min=0.0), dim=-1)


def pairwise_ioa(boxes1, boxes2) -> torch.Tensor:
    """(N, M) intersection over boxes2 volume (`boxes.py:245-262`)."""
    vol2 = volume(boxes2)
    inter = pairwise_intersection(boxes1, boxes2)
    return torch.where(inter > 0, inter / vol2[None, :],
                       torch.zeros_like(inter))


def matched_pairwise_iou(boxes1, boxes2) -> torch.Tensor:
    """(N,) IoU of matched (paired) boxes, intersected in 3D
    (`boxes.py:265-290` without its depth slip)."""
    b1, b2 = _f32(boxes1), _f32(boxes2)
    lt = torch.maximum(b1[:, :3], b2[:, :3])
    rb = torch.minimum(b1[:, 3:], b2[:, 3:])
    inter = torch.prod((rb - lt).clamp(min=0.0), dim=-1)
    return inter / (volume(b1) + volume(b2) - inter)
