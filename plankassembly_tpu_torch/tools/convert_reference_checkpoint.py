"""Convert a reference PyTorch-Lightning checkpoint (`.ckpt`) into a
training checkpoint of the port (the port's counterpart of
`tools/convert_torch_checkpoint.py`, with its key mapping).

  python -m plankassembly_tpu_torch.tools.convert_reference_checkpoint \\
      --ckpt model.ckpt --out <run>/checkpoints/reference.pt \\
      [--hparams checkpoints/mha_complete_ep59.hparams.yaml]

The reference publishes trained `.ckpt` files (`README.md:152-156`). Its
module tree (`plankassembly/models.py:47-74`): Lightning prefixes every
key with ``model.``; torch Linear weights are (out, in), so they
transpose; `nn.MultiheadAttention` packs Q, K and V into the rows of
`in_proj_weight` (so the reference's models are MHA). The result is the
port's parameter dict (the JAX package's layout, layers stacked) written
as `<out>` at step 0 with no optimizer state; it loads with
`Trainer.load_checkpoint`, and with `checkpoint.load_checkpoint` once
`--hparams` has put the model's config at `<run>/hparams.yaml`.
`reference_state_dict` is the inverse mapping (an MHA parameter dict ->
the reference's state dict).
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from plankassembly_tpu_torch.checkpoint import _training_file, tree_map


def _t(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32).T)


def _a(x):
    return np.asarray(x, dtype=np.float32)


def convert_state_dict(sd: dict, num_encoder_layers=6, num_decoder_layers=6):
    """Map a reference state_dict (numpy arrays or CPU tensors) to the
    parameter layout of `models/model.py::init_params` (layer-stacked
    float32 numpy arrays)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    p = "model."

    embed = {
        "value": _a(sd[p + "input_embeddings.input_value.weight"]),
        "pos_in": _a(sd[p + "input_embeddings.input_pos.weight"]),
        "coord_in": _a(sd[p + "input_embeddings.input_coord.weight"]),
        "view": _a(sd[p + "input_embeddings.input_view.weight"]),
        "type": _a(sd[p + "input_embeddings.input_type.weight"]),
        "coord_out": _a(sd[p + "query_coord_embedding.weight"]),
        "pos_out": _a(sd[p + "query_pos_embedding.weight"]),
    }

    def attn(prefix, layers, torch_name):
        wq, wk, wv, wo = [], [], [], []
        bq, bk, bv, bo = [], [], [], []
        for i in range(layers):
            w = sd[f"{prefix}.layers.{i}.{torch_name}.in_proj_weight"]
            b = sd[f"{prefix}.layers.{i}.{torch_name}.in_proj_bias"]
            d = w.shape[1]
            wq.append(_t(w[:d])); wk.append(_t(w[d:2 * d])); wv.append(_t(w[2 * d:]))
            bq.append(_a(b[:d])); bk.append(_a(b[d:2 * d])); bv.append(_a(b[2 * d:]))
            wo.append(_t(sd[f"{prefix}.layers.{i}.{torch_name}.out_proj.weight"]))
            bo.append(_a(sd[f"{prefix}.layers.{i}.{torch_name}.out_proj.bias"]))
        return {"wq": np.stack(wq), "wk": np.stack(wk), "wv": np.stack(wv),
                "wo": np.stack(wo), "bq": np.stack(bq), "bk": np.stack(bk),
                "bv": np.stack(bv), "bo": np.stack(bo)}

    def ffn(prefix, layers):
        return {
            "w1": np.stack([_t(sd[f"{prefix}.layers.{i}.linear1.weight"])
                            for i in range(layers)]),
            "b1": np.stack([_a(sd[f"{prefix}.layers.{i}.linear1.bias"])
                            for i in range(layers)]),
            "w2": np.stack([_t(sd[f"{prefix}.layers.{i}.linear2.weight"])
                            for i in range(layers)]),
            "b2": np.stack([_a(sd[f"{prefix}.layers.{i}.linear2.bias"])
                            for i in range(layers)]),
        }

    def norm(prefix, layers, name):
        return {
            "scale": np.stack([_a(sd[f"{prefix}.layers.{i}.{name}.weight"])
                               for i in range(layers)]),
            "bias": np.stack([_a(sd[f"{prefix}.layers.{i}.{name}.bias"])
                              for i in range(layers)]),
        }

    def final_norm(prefix):
        return {"scale": _a(sd[f"{prefix}.norm.weight"]),
                "bias": _a(sd[f"{prefix}.norm.bias"])}

    enc = p + "encoder"
    encoder = {
        "self_attn": attn(enc, num_encoder_layers, "self_attn"),
        "ffn": ffn(enc, num_encoder_layers),
        "norm1": norm(enc, num_encoder_layers, "norm1"),
        "norm2": norm(enc, num_encoder_layers, "norm2"),
        "final_norm": final_norm(enc),
    }
    dec = p + "decoder"
    decoder = {
        "self_attn": attn(dec, num_decoder_layers, "self_attn"),
        "cross_attn": attn(dec, num_decoder_layers, "multihead_attn"),
        "ffn": ffn(dec, num_decoder_layers),
        "norm1": norm(dec, num_decoder_layers, "norm1"),
        "norm2": norm(dec, num_decoder_layers, "norm2"),
        "norm3": norm(dec, num_decoder_layers, "norm3"),
        "final_norm": final_norm(dec),
    }
    heads = {
        "vocab": {"w": _t(sd[p + "vocab_head.weight"]),
                  "b": _a(sd[p + "vocab_head.bias"])},
        "pointer": {"w": _t(sd[p + "pointer_head.weight"]),
                    "b": _a(sd[p + "pointer_head.bias"])},
        "switch": {"w": _t(sd[p + "switch_head.weight"]),
                   "b": _a(sd[p + "switch_head.bias"])},
    }
    return {"embed": embed, "encoder": encoder, "decoder": decoder,
            "heads": heads}


def reference_state_dict(params: dict) -> dict:
    """The reference's state dict (float32 CPU tensors under ``model.``) of
    an MHA parameter dict of the port: the inverse of `convert_state_dict`.
    Raises ValueError for grouped-query attention, which the reference's
    `nn.MultiheadAttention` cannot hold."""
    p = tree_map(lambda t: torch.as_tensor(t).detach().float().cpu(), params)
    sd = {}
    for name, key in (("input_embeddings.input_value", "value"),
                      ("input_embeddings.input_pos", "pos_in"),
                      ("input_embeddings.input_coord", "coord_in"),
                      ("input_embeddings.input_view", "view"),
                      ("input_embeddings.input_type", "type"),
                      ("query_coord_embedding", "coord_out"),
                      ("query_pos_embedding", "pos_out")):
        sd[f"model.{name}.weight"] = p["embed"][key]

    def attn(prefix, a):
        if a["wk"].shape != a["wq"].shape:
            raise ValueError("grouped-query attention has no reference "
                             "(nn.MultiheadAttention) layout")
        for i in range(a["wq"].shape[0]):
            pre = prefix.format(i)
            sd[f"{pre}.in_proj_weight"] = torch.cat(
                [a["wq"][i].T, a["wk"][i].T, a["wv"][i].T]).contiguous()
            sd[f"{pre}.in_proj_bias"] = torch.cat(
                [a["bq"][i], a["bk"][i], a["bv"][i]])
            sd[f"{pre}.out_proj.weight"] = a["wo"][i].T.contiguous()
            sd[f"{pre}.out_proj.bias"] = a["bo"][i]

    def layers(stack, tree, norms):
        for i in range(tree["ffn"]["w1"].shape[0]):
            pre = f"{stack}.layers.{i}"
            for name, key in (("linear1", "1"), ("linear2", "2")):
                sd[f"{pre}.{name}.weight"] = \
                    tree["ffn"]["w" + key][i].T.contiguous()
                sd[f"{pre}.{name}.bias"] = tree["ffn"]["b" + key][i]
            for name in norms:
                sd[f"{pre}.{name}.weight"] = tree[name]["scale"][i]
                sd[f"{pre}.{name}.bias"] = tree[name]["bias"][i]
        sd[f"{stack}.norm.weight"] = tree["final_norm"]["scale"]
        sd[f"{stack}.norm.bias"] = tree["final_norm"]["bias"]

    enc, dec = p["encoder"], p["decoder"]
    attn("model.encoder.layers.{}.self_attn", enc["self_attn"])
    layers("model.encoder", enc, ("norm1", "norm2"))
    attn("model.decoder.layers.{}.self_attn", dec["self_attn"])
    attn("model.decoder.layers.{}.multihead_attn", dec["cross_attn"])
    layers("model.decoder", dec, ("norm1", "norm2", "norm3"))
    for name in ("vocab", "pointer", "switch"):
        sd[f"model.{name}_head.weight"] = \
            p["heads"][name]["w"].T.contiguous()
        sd[f"model.{name}_head.bias"] = p["heads"][name]["b"]
    return sd


def main(argv=None):
    args = parse_args(argv)
    from plankassembly_tpu_torch.train.state import tree_leaves

    # a Lightning checkpoint pickles more than tensors (hyper-parameters,
    # loop state), so it is read in full: convert only files you trust
    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    params = convert_state_dict(sd, args.encoder_layers, args.decoder_layers)
    params = tree_map(torch.from_numpy, params)
    out = os.path.abspath(_training_file(args.out))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # no optimizer state: the trainer that loads it starts a fresh Adam
    # at its config's learning rate
    torch.save({"params": {"/".join(k): t for k, t in tree_leaves(params)},
                "opt_state": None, "step": 0}, out)
    if args.hparams:
        shutil.copy(args.hparams, os.path.join(
            os.path.dirname(os.path.dirname(out)), "hparams.yaml"))
    print(f"converted {args.ckpt} -> {out}")
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m plankassembly_tpu_torch.tools."
             "convert_reference_checkpoint",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", required=True, help="Lightning .ckpt path")
    parser.add_argument("--out", required=True,
                        help="the port's training checkpoint (<run>/"
                        "checkpoints/<tag>.pt)")
    parser.add_argument("--encoder_layers", type=int, default=6)
    parser.add_argument("--decoder_layers", type=int, default=6)
    parser.add_argument("--hparams", default=None,
                        help="a config (.hparams.yaml) to copy to "
                        "<run>/hparams.yaml")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
