"""Input packing and output parsing, plain numpy: a frozen copy of the
semantics the benchmark holds the program to.

Copied from `plankassembly_tpu_torch/tokens.py::quantize_values`,
`data/packing.py::pack_input_sequence`, `decode.py::parse_sequence` and
`serving.py::postprocess_prediction` (which copy the PlankAssembly
reference's `line_data.py:34-83`). Frozen here so that a change to the
program's packing shows as a mismatch instead of moving the yardstick.
"""
from __future__ import annotations

import numpy as np


def quantize_values(verts, n_bits: int) -> np.ndarray:
    """Coords in [-1, 1] -> integers in [0, 2**n_bits - 1], truncated
    toward zero like the reference's int cast."""
    q = (np.asarray(verts, dtype=np.float64) + 1.0) * (2 ** n_bits - 1) / 2.0
    return q.astype(np.int64)


def pack_input(lines, views, types, data: dict, token: dict,
               with_type: bool = True) -> dict:
    """(K, 4) line bounds, (K,) views and types -> the encoder's token
    streams, each MAX_INPUT_LENGTH - 1 long (the reference's off-by-one pad
    kept), input_mask True at padding."""
    dof, end, pad = data["NUM_INPUT_DOF"], token["END"], token["PAD"]
    lines = np.asarray(lines, dtype=np.float64).reshape(-1, dof)
    value = quantize_values(lines, data["NUM_BITS"])
    view = np.asarray(views, dtype=np.int64).reshape(-1)
    typ = np.asarray(types, dtype=np.int64).reshape(-1) if with_type else None
    if len(lines):
        keyed = np.concatenate((value, view[:, None]), axis=1)
        order = np.lexsort(keyed.T[[3, 1, 2, 0, 4]])
        value, view = value[order].flatten(), view[order]
        if with_type:
            typ = np.repeat(typ[order], dof)
        _, counts = np.unique(view, return_counts=True)
        pos = np.repeat(np.concatenate([np.arange(c) for c in counts]), dof)
        coord = np.arange(len(value)) % dof
        view = np.repeat(view, dof)
    else:
        value = value.flatten()
        pos = np.zeros_like(view)
        coord = np.zeros_like(view)
    value = np.append(value, end)
    n = len(value)
    if n > data["MAX_INPUT_LENGTH"]:
        raise ValueError(f"{n} input tokens exceed MAX_INPUT_LENGTH")
    rest = data["MAX_INPUT_LENGTH"] - n
    out = {
        "input_value": np.pad(value, (0, rest - 1), constant_values=pad),
        "input_pos": np.pad(pos, (0, rest)),
        "input_coord": np.pad(coord, (0, rest)),
        "input_view": np.pad(view, (0, rest)),
    }
    out["input_mask"] = out["input_value"] == pad
    if with_type:
        out["input_type"] = np.pad(typ, (0, rest))
    return {k: (v if k == "input_mask" else v.astype(np.int64))
            for k, v in out.items()}


def parse_sequence(sequence, end: int, dof: int) -> np.ndarray:
    """Tokens up to the first END, as (P, dof) rows."""
    sequence = np.asarray(sequence)
    ends = np.flatnonzero(sequence == end)
    valid = sequence[: ends[0]] if len(ends) else sequence
    return valid[: len(valid) // dof * dof].reshape(-1, dof)


def postprocess(sample_row, attach_row, end: int, dof: int):
    """(planks (N, 6) with the bbox row first, attachment lists) of a
    decoded row, zero-extent planks dropped as the eval dump drops them."""
    pred = parse_sequence(sample_row, end, dof)
    if len(pred) > 0:
        body = pred[1:]
        keep = np.all(np.abs(body[:, 3:] - body[:, :3]) != 0, axis=1)
        pred = np.concatenate([pred[:1], body[keep]])
    attach = np.asarray(attach_row)[: pred.size].reshape(-1, 6).tolist()
    return pred, attach
