"""Model operations of the PlankAssembly encoder-decoder, from its shapes.

The counts follow `chip_smoke.py::decode_bound` (copied; the least-time
arithmetic is in `_bounds.py`): a product of (m, k) by (k, n) is 2mkn
operations, attention is 4 * D operations per (query, key) pair (scores
and weighted sum over all heads), and only real tokens count: padding
and the steps a row runs past its own END are work the inputs do not
need.
"""
from __future__ import annotations


def dims_of(config: dict) -> dict:
    """The sizes the counts use, from a configuration file's sections."""
    m, d = config["MODEL"], config["DATA"]
    D, H = m["NUM_MODEL"], m["NUM_HEAD"]
    kvH = m.get("NUM_KV_HEAD") or H
    return {"D": D, "H": H, "Dh": D // H, "Dkv": kvH * (D // H),
            "F": m["NUM_FEEDFORWARD"], "Le": m["NUM_ENCODER_LAYERS"],
            "Ld": m["NUM_DECODER_LAYERS"], "V": d["VOCAB_SIZE"],
            "S": d["MAX_OUTPUT_LENGTH"], "dof": d["NUM_OUTPUT_DOF"]}


def encoder_flops(d: dict, n: int) -> float:
    """One row of n real tokens through the encoder stack."""
    D = d["D"]
    per_token = 2.0 * (2 * D * D + 2 * D * d["Dkv"] + 2 * D * d["F"])
    return d["Le"] * (n * per_token + 4.0 * D * n * n)


def decoder_layer_flops(d: dict) -> float:
    """One row's products of one decoder layer at one step: self q/k/v/o,
    cross q/o and the FFN (the bf16 part of a step)."""
    D, Dkv, F = d["D"], d["Dkv"], d["F"]
    return 2.0 * (D * (D + 2 * Dkv) + 3 * D * D + 2 * D * F)


def head_flops(d: dict, t: int) -> float:
    """One row's vocab, pointer and switch heads at step t (f32)."""
    D = d["D"]
    return 2.0 * D * (d["V"] + D + 1) + 2.0 * D * t


def decoder_flops(d: dict, n: int, steps: int) -> float:
    """One row with n real memory tokens decoded for `steps` steps: the
    cross K/V projection of its memory, each step's layers, attention
    over the keys so far and over its memory, and the heads."""
    D, Ld = d["D"], d["Ld"]
    total = 2.0 * n * D * 2 * d["Dkv"] * Ld
    for t in range(steps):
        total += Ld * (decoder_layer_flops(d) + 4.0 * D * (t + 1)
                       + 4.0 * D * n)
        total += head_flops(d, t)
    return total


def program_flops(d: dict, n: int, steps: int) -> float:
    """A served program: its encoder pass and its own decoded steps."""
    return encoder_flops(d, n) + decoder_flops(d, n, steps)
