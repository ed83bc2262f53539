"""Static-shape sequence packing (pure numpy); a copy of
`plankassembly_tpu/data/packing.py`.

Converts per-sample geometry into the fixed-length token streams the model
consumes. Semantics match the reference exactly:

- input packing: `plankassembly/datasets/line_data.py:34-83`
- output packing with attachment-pointer labels: `line_data.py:85-109`

One reference quirk preserved deliberately: every input stream is padded to
``MAX_INPUT_LENGTH - 1`` tokens (the reference pads the value stream by
``pad_length - 1`` *after* appending END, `line_data.py:67`), so the static
encoder length is 1199/999/299, not 1200/1000/300. Static shapes are what XLA
wants, so the off-by-one is simply part of the shape contract.
"""
from __future__ import annotations

import numpy as np

from plankassembly_tpu_torch.config import DataConfig, TokenConfig
from plankassembly_tpu_torch.tokens import quantize_values


def input_length(cfg: DataConfig) -> int:
    """Static encoder sequence length."""
    return cfg.MAX_INPUT_LENGTH - 1


def pack_input_sequence(lines, views, types, cfg: DataConfig, token: TokenConfig,
                        with_type: bool = True) -> dict[str, np.ndarray]:
    """Pack 2D line bounds into flat token streams.

    Args:
      lines: (K, 4) float bounds (xmin, ymin, xmax, ymax) in [-1, 1].
      views: (K,) int view index in [0, 3).
      types: (K,) int line type (0 visible / 1 hidden); ignored when
        ``with_type`` is False (sideface modality drops the type stream,
        `sideface_data.py:179-185`).

    Returns dict of int64/bool arrays, each of length MAX_INPUT_LENGTH - 1:
      input_value, input_pos, input_coord, input_view, [input_type],
      input_mask (True = padding).
    """
    lines = np.asarray(lines, dtype=np.float64).reshape(-1, cfg.NUM_INPUT_DOF)
    input_value = quantize_values(lines, cfg.NUM_BITS)
    input_view = np.asarray(views, dtype=np.int64).reshape(-1)
    input_type = np.asarray(types, dtype=np.int64).reshape(-1) if with_type else None

    if len(lines) != 0:
        # sort by (view, xmin, xmax, ymin, ymax) — reference lexsort with key
        # rows [3,1,2,0,4] (`line_data.py:41-42`; np.lexsort is last-key-primary)
        line_with_view = np.concatenate(
            (input_value, input_view[..., np.newaxis]), axis=1)
        sort_inds = np.lexsort(line_with_view.T[[3, 1, 2, 0, 4]])

        input_value = input_value[sort_inds].flatten()
        input_view = input_view[sort_inds]
        if with_type:
            input_type = input_type[sort_inds]

        # per-view position ids (`line_data.py:49-50`)
        _, counts = np.unique(input_view, return_counts=True)
        input_pos = np.concatenate([np.arange(count) for count in counts])

        # per-token coordinate ids (`line_data.py:53`)
        input_coord = np.arange(len(input_value)) % cfg.NUM_INPUT_DOF

        # repeat per-line streams for each of the 4 tokens (`line_data.py:56-58`)
        input_pos = np.repeat(input_pos, cfg.NUM_INPUT_DOF)
        input_view = np.repeat(input_view, cfg.NUM_INPUT_DOF)
        if with_type:
            input_type = np.repeat(input_type, cfg.NUM_INPUT_DOF)
    else:
        # empty-input degenerate case (`sideface_data.py:161-164`)
        input_value = input_value.flatten()
        input_pos = np.zeros_like(input_view)
        input_coord = np.zeros_like(input_view)

    # stop token + padding (`line_data.py:60-72`)
    input_value = np.append(input_value, token.END)
    num_input = len(input_value)
    if num_input > cfg.MAX_INPUT_LENGTH:
        raise ValueError(f"{num_input} input tokens exceed "
                         f"MAX_INPUT_LENGTH={cfg.MAX_INPUT_LENGTH}")
    pad_length = cfg.MAX_INPUT_LENGTH - num_input

    input_value = np.pad(input_value, (0, pad_length - 1), constant_values=token.PAD)
    input_pos = np.pad(input_pos, (0, pad_length))
    input_coord = np.pad(input_coord, (0, pad_length))
    input_view = np.pad(input_view, (0, pad_length))
    input_mask = input_value == token.PAD

    out = {
        "input_value": input_value.astype(np.int64),
        "input_pos": input_pos.astype(np.int64),
        "input_coord": input_coord.astype(np.int64),
        "input_view": input_view.astype(np.int64),
        "input_mask": input_mask,
    }
    if with_type:
        out["input_type"] = np.pad(input_type, (0, pad_length)).astype(np.int64)
    return out


def pack_output_sequence(planks, attach, cfg: DataConfig,
                         token: TokenConfig) -> dict[str, np.ndarray]:
    """Pack the 3D shape program into value/label/mask streams.

    Args:
      planks: (6*P,) flat continuous coords (row 0 = global bbox).
      attach: (6*P,) pointer indices (-1 = no attachment, else index of the
        earlier output token this coordinate copies).

    Labels are over the mixed vocab∪pointer space: attached coordinates get
    ``attach + VOCAB_SIZE`` (`line_data.py:98-101`).
    """
    planks = np.asarray(planks, dtype=np.float64).reshape(-1)
    attach = np.asarray(attach, dtype=np.int64).reshape(-1)

    value = quantize_values(planks, cfg.NUM_BITS)
    value = np.append(value, token.END)
    num_output = len(value)
    if num_output > cfg.MAX_OUTPUT_LENGTH:
        raise ValueError(f"{num_output} output tokens exceed "
                         f"MAX_OUTPUT_LENGTH={cfg.MAX_OUTPUT_LENGTH}")

    value = np.pad(value, (0, cfg.MAX_OUTPUT_LENGTH - num_output),
                   constant_values=token.PAD)
    mask = value == token.PAD

    label = np.pad(attach, (0, cfg.MAX_OUTPUT_LENGTH - len(attach)),
                   constant_values=-1)
    label = label.copy()
    label[label != -1] += cfg.VOCAB_SIZE
    label[label == -1] = value[label == -1]

    return {
        "output_value": value.astype(np.int64),
        "output_label": label.astype(np.int64),
        "output_mask": mask,
    }
