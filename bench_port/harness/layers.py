"""Ranges around the model's two layers as `decode.greedy_decode` calls
them (`decode.encode`, `decode.decode_from_memory`), with what their
bounds need. The masks are kept as they are and read after the window,
so a traced call waits for nothing it would not wait for."""
from __future__ import annotations


def wrap_decode(trace, D) -> None:
    """D: the program's `decode` module."""
    trace.wrap(D, "encode", "encode", info=_encode)
    trace.wrap(D, "decode_from_memory", "decode_from_memory", info=_decode)


def _encode(args, kwargs, out):
    inputs = args[1]
    return {"mask": inputs["input_mask"],
            "streams": sum(1 for k in inputs
                           if k.startswith("input") and k != "input_mask")}


def _decode(args, kwargs, out):
    return {"mask": args[2], "steps": int(out["num_steps"])}
