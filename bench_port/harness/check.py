"""How `correct` is decided for a served model: a sample of the programs
the timed path finished, one of every distinct request it served (the
instance drawn from the seed, the longest program among them), judged by
the plain reference.

For each sampled program the reference, from the request alone:
- packs the request again and compares every input stream with what the
  program packed: `pack_mismatches`, exact;
- post-processes the served tokens and compares the planks and
  attachments with the program's answer: `answer_mismatches`, exact;
- checks that every pointer the program followed points back and copied
  the token it points to: `pointer_faults`, exact;
- runs the model in float32 over the request and the served tokens
  (teacher forced, up to and including the first END) and takes, at every
  position, how far below the reference's best candidate the served one
  lies, in log-probability: `max_gap`, the widest over the sample.

The control puts the reference in float8 (`reference/model.py`) in the
program's place: at the same positions its choice is the candidate that
float8 puts first, and its `max_gap` is the float32 gap of that choice.
It is judged against the same limits, and has to come out not correct.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from bench_port.reference import packing as RP
from bench_port.reference.model import Reference, load_npz

BLOCK_ROWS = 16


def sample_indices(keys, lengths, seed: int) -> list[int]:
    """One finished program of every distinct request (`keys`: the pool
    drawing of each finished program), the instance drawn from the seed,
    and the longest program of all in place of its drawing's draw."""
    rng = np.random.default_rng([seed, 7])
    groups: dict = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    pick = {k: int(rng.choice(v)) for k, v in sorted(groups.items())}
    longest = int(np.argmax(lengths))
    pick[keys[longest]] = longest
    return sorted(pick.values())


def served_length(tokens, end: int) -> int:
    """Positions up to and including the first END (all if none)."""
    ends = np.flatnonzero(np.asarray(tokens) == end)
    return int(ends[0]) + 1 if len(ends) else len(tokens)


def pack_request(body: dict, config: dict) -> dict:
    return RP.pack_input(body["lines"], body["views"], body["types"],
                         config["DATA"], config["TOKEN"], with_type=True)


def _same_answer(ref, answer) -> bool:
    pred, attach = ref
    got_pred, got_attach = answer
    return (np.array_equal(np.asarray(pred).reshape(-1, 6),
                           np.asarray(got_pred).reshape(-1, 6))
            and list(map(list, attach)) == list(map(list, got_attach)))


def judge(items: list[dict], config: dict, root: str, device,
          control: bool = False) -> tuple[dict, dict | None]:
    """items: dicts with `body` (the request), `packed` (the program's
    input streams), `tokens` and `attach` (the served row) and `answer`
    ((planks, attachments) as the program answered). Returns the
    program's readings by name, and with `control` the float8 control's
    (else None)."""
    data, token = config["DATA"], config["TOKEN"]
    end, dof, V = token["END"], data["NUM_OUTPUT_DOF"], data["VOCAB_SIZE"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        w = load_npz(os.path.join(root, config["checkpoint"]), device)
        ref = Reference(w, config["MODEL"], data, token)
        low = (Reference(w, config["MODEL"], data, token, fmt="fp8")
               if control else None)
        out = {"pack_mismatches": 0, "answer_mismatches": 0,
               "pointer_faults": 0, "max_gap": 0.0, "tokens": 0}
        ctl = {"max_gap": 0.0} if control else None
        for lo in range(0, len(items), BLOCK_ROWS):
            block = items[lo:lo + BLOCK_ROWS]
            packs = [pack_request(it["body"], config) for it in block]
            for it, p in zip(block, packs):
                prog = {k: np.asarray(v) for k, v in it["packed"].items()
                        if k.startswith("input")}
                if set(prog) != set(p) or any(
                        not np.array_equal(prog[k], p[k]) for k in p):
                    out["pack_mismatches"] += 1
                if not _same_answer(RP.postprocess(it["tokens"], it["attach"],
                                                   end, dof), it["answer"]):
                    out["answer_mismatches"] += 1
            lens = [served_length(it["tokens"], end) for it in block]
            T = max(lens)
            width = max(int((~p["input_mask"]).sum()) for p in packs)
            inputs = {k: torch.from_numpy(np.stack([p[k][:width] for p in packs])
                                          ).to(device) for k in packs[0]}
            toks = np.zeros((len(block), T), np.int64)
            choice = np.zeros((len(block), T), np.int64)
            valid = np.zeros((len(block), T), bool)
            for i, (it, n) in enumerate(zip(block, lens)):
                tk = np.asarray(it["tokens"][:n], np.int64)
                at = np.asarray(it["attach"][:n], np.int64)
                toks[i, :n] = tk
                valid[i, :n] = True
                for t in np.flatnonzero(at >= 0):
                    if at[t] >= t or tk[t] != tk[at[t]]:
                        out["pointer_faults"] += 1
                choice[i, :n] = np.where(at >= 0, V + np.maximum(at, 0), tk)
            tt = torch.from_numpy(toks).to(device)
            with torch.no_grad():
                s = ref.step_scores(inputs, tt)
                best = s.max(-1).values
                ch = torch.from_numpy(choice).to(device)
                gap = best - s.gather(-1, ch[..., None])[..., 0]
                vm = torch.from_numpy(valid).to(device)
                out["max_gap"] = max(out["max_gap"],
                                     float(gap[vm].max().item()))
                out["tokens"] += int(vm.sum().item())
                if control:
                    first = low.step_scores(inputs, tt).argmax(-1)
                    cg = best - s.gather(-1, first[..., None])[..., 0]
                    ctl["max_gap"] = max(ctl["max_gap"],
                                         float(cg[vm].max().item()))
            del s
        return out, ctl
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def verdict(readings: dict, limits: dict) -> list[tuple[str, float, float]]:
    """(name, reading, limit) of each number compared."""
    return [(k, readings[k], limits[k]) for k in limits if k in readings]
