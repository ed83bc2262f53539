"""The PlankAssembly encoder-decoder in plain PyTorch, float32, teacher
forced: the yardstick that served programs are judged by.

It reads the released checkpoint file itself (a flat npz of bf16 arrays
stored as 2-byte voids) and recomputes everything from the inputs the
harness hands it: no weights, caches or tables of the program. The
layer equations are the published pre-norm Transformer of the
PlankAssembly paper (ICCV 2023) with this repository's grouped-query K/V
(`NUM_KV_HEAD`): query head h reads K/V head h // (H / kvH).

`step_scores` runs the decoder over a served token sequence at once (a
causal mask in place of a K/V cache) and gives, at every position, the
log-scores of the greedy sampler's candidates: the vocab's log-softmax
at the first NUM_OUTPUT_DOF - 1 positions, later the log of the mixed
vocab || pointer || switch distribution with the reference's quirks
(pointer slots an attachment rule forbids hold eps, later slots -1).

`fmt="fp8"` rounds both operands of every product (projections, FFN,
attention scores and their weighted sum, the heads and the pointer's
scores) to float8 e4m3 with one scale per tensor, and keeps the sums,
softmaxes and norms in float32: the nearest precision below the bf16
the configurations serve in, for the control run.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e9
EPS = 1e-6
FP8_MAX = 448.0


def load_npz(path, device) -> dict:
    """Flat {"a/b/c": float32 tensor} of a released checkpoint."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            if k == "__step__":
                continue
            a = z[k]
            if a.dtype.kind == "V" and a.dtype.itemsize == 2:
                t = torch.from_numpy(a.view(np.uint16).astype(np.int32) << 16)
                t = t.view(torch.float32)
            else:
                t = torch.from_numpy(np.asarray(a, dtype=np.float32))
            out[k] = t.to(device)
    return out


def _fp8(x):
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """Weights `w` (from `load_npz`) and the configuration's MODEL / DATA /
    TOKEN sections."""

    def __init__(self, w: dict, model: dict, data: dict, token: dict,
                 fmt: str | None = None):
        self.w, self.fmt = w, fmt
        self.D = model["NUM_MODEL"]
        self.H = model["NUM_HEAD"]
        self.kvH = model.get("NUM_KV_HEAD") or self.H
        self.Dh = self.D // self.H
        self.L_enc = model["NUM_ENCODER_LAYERS"]
        self.L_dec = model["NUM_DECODER_LAYERS"]
        self.V = data["VOCAB_SIZE"]
        self.dof = data["NUM_OUTPUT_DOF"]
        self.S = data["MAX_OUTPUT_LENGTH"]
        self.end = token["END"]

    def mm(self, x, w):
        if self.fmt == "fp8":
            return _fp8(x) @ _fp8(w)
        return x @ w

    def einsum(self, eq, a, b):
        if self.fmt == "fp8":
            a, b = _fp8(a), _fp8(b)
        return torch.einsum(eq, a, b)

    def _ln(self, p, x, l=None):
        s, b = self.w[p + "/scale"], self.w[p + "/bias"]
        if l is not None:
            s, b = s[l], b[l]
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5) * s + b

    def _lin(self, p, name, x, l):
        return self.mm(x, self.w[f"{p}/w{name}"][l]) + self.w[f"{p}/b{name}"][l]

    def _attn(self, p, l, xq, xkv, bias):
        B, Lq, _ = xq.shape
        q = self._lin(p, "q", xq, l).view(B, Lq, self.H, self.Dh)
        k = self._lin(p, "k", xkv, l).view(B, -1, self.kvH, self.Dh)
        v = self._lin(p, "v", xkv, l).view(B, -1, self.kvH, self.Dh)
        g = self.H // self.kvH
        k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
        s = self.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.Dh)
        a = torch.softmax(s + bias, dim=-1)
        o = self.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, Lq, self.D)
        return self._lin(p, "o", o, l)

    def _ffn(self, p, l, x):
        h = torch.relu(self.mm(x, self.w[p + "/w1"][l]) + self.w[p + "/b1"][l])
        return self.mm(h, self.w[p + "/w2"][l]) + self.w[p + "/b2"][l]

    def encode(self, inputs: dict):
        """inputs: (B, Li) tensors of the packed streams; memory (B, Li, D)
        and its additive pad bias (B, 1, 1, Li)."""
        e = self.w
        x = (e["embed/value"][inputs["input_value"]]
             + e["embed/pos_in"][inputs["input_pos"]]
             + e["embed/coord_in"][inputs["input_coord"]]
             + e["embed/view"][inputs["input_view"]])
        if "input_type" in inputs:
            x = x + e["embed/type"][inputs["input_type"]]
        bias = torch.where(inputs["input_mask"], NEG_INF, 0.0)[:, None, None]
        for l in range(self.L_enc):
            x = x + self._attn("encoder/self_attn", l,
                               self._ln("encoder/norm1", x, l),
                               self._ln("encoder/norm1", x, l), bias)
            x = x + self._ffn("encoder/ffn", l, self._ln("encoder/norm2", x, l))
        return self._ln("encoder/final_norm", x), bias

    def decode(self, tokens, memory, mem_bias):
        """Final hidden states (B, T, D) at positions 0..T-1 of the served
        tokens (B, T): position t reads a zero vector at t = 0, else token
        t-1 with its coordinate (t-1) % dof and plank (t-1) // dof
        embeddings."""
        e = self.w
        B, T = tokens.shape
        t = torch.arange(T - 1, device=tokens.device)
        x = (e["embed/value"][tokens[:, :-1]]
             + e["embed/coord_out"][t % self.dof][None]
             + e["embed/pos_out"][t // self.dof][None])
        x = torch.cat([torch.zeros_like(x[:, :1]), x], dim=1)
        causal = torch.triu(torch.full((T, T), NEG_INF, device=x.device),
                            diagonal=1)[None, None]
        for l in range(self.L_dec):
            h = self._ln("decoder/norm1", x, l)
            x = x + self._attn("decoder/self_attn", l, h, h, causal)
            h = self._ln("decoder/norm2", x, l)
            x = x + self._attn("decoder/cross_attn", l, h, memory, mem_bias)
            x = x + self._ffn("decoder/ffn", l, self._ln("decoder/norm3", x, l))
        return self._ln("decoder/final_norm", x)

    def step_scores(self, inputs: dict, tokens):
        """(B, T, V + T) log-scores of the sampler's candidates at each
        position of the served tokens (B, T); -inf where a candidate is
        not one (a later pointer slot)."""
        memory, bias = self.encode(inputs)
        h = self.decode(tokens, memory, bias)
        T = tokens.shape[1]
        wv, bv = self.w["heads/vocab/w"], self.w["heads/vocab/b"]
        vocab = self.mm(h, wv) + bv
        feat = self.mm(h, self.w["heads/pointer/w"]) + self.w["heads/pointer/b"]
        ptr = self.einsum("btd,bsd->bts", feat, h) / self.D
        prob = torch.sigmoid(self.mm(h, self.w["heads/switch/w"])
                             + self.w["heads/switch/b"])
        pos = torch.arange(T, device=h.device)
        later_or_self = pos[None, :] >= pos[:, None]          # (t, j): j >= t
        ptr = torch.softmax(ptr + torch.where(later_or_self, NEG_INF, 0.0),
                            dim=-1) * prob
        struct = torch.from_numpy(structure_mask(self.S, self.dof)[:T, :T]
                                  ).to(h.device)
        ptr = torch.where(struct[None] == 0, EPS, ptr)
        ptr = torch.where((pos[None, :] > pos[:, None])[None], -1.0, ptr)
        mixed = torch.cat([torch.softmax(vocab, -1) * (1 - prob), ptr], -1)
        score = torch.where(mixed > 0, torch.log(mixed.clamp(min=1e-38)),
                            -math.inf)
        first = torch.log_softmax(vocab, -1)
        plain = (pos + 1 < self.dof)[None, :, None]
        first = torch.cat([first, torch.full_like(ptr, -math.inf)], -1)
        return torch.where(plain, first, score)


def structure_mask(S: int, dof: int) -> np.ndarray:
    """(S, S) legal attachments: coordinate k of a plank points to
    coordinate (k + 3) % 6 of an earlier plank or the same coordinate of
    the bbox row; bbox tokens never point."""
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    plank = (j % dof) == ((i % dof) + dof // 2) % dof
    bbox = (j % dof) == (i % dof)
    m = np.where(j < dof, bbox, plank).astype(np.float32)
    m[:dof, :] = 0.0
    return m
